"""ViT-B/16 (Dosovitskiy et al. 2020, Table 1, ViT-Base): patch embedding,
a class token, learned positions, pre-norm encoder blocks (softmax
attention, a tanh-GELU MLP), a final LayerNorm and a dense head on the
class token. Parameter names follow the port's state dict."""
import math

import torch
import torch.nn.functional as F

from cardbench.reference.precision import operand


def param_specs(cfg):
    d, m, p = cfg["hidden_size"], cfg["intermediate_size"], cfg["patch_size"]
    tokens = (cfg["image_size"] // p) ** 2 + 1
    specs = [("cls", (1, 1, d), "embed"),
             ("pos_embedding", (1, tokens, d), "embed"),
             ("patch_embedding.weight", (d, cfg["in_channels"], p, p), "fan_in"),
             ("patch_embedding.bias", (d,), "bias")]
    for i in range(cfg["num_hidden_layers"]):
        b = f"block{i}"
        specs += [(f"{b}.norm1.weight", (d,), "scale"),
                  (f"{b}.norm1.bias", (d,), "bias")]
        for proj in ("query", "key", "value", "out"):
            specs += [(f"{b}.attn.{proj}.weight", (d, d), "fan_in"),
                      (f"{b}.attn.{proj}.bias", (d,), "bias")]
        specs += [(f"{b}.norm2.weight", (d,), "scale"),
                  (f"{b}.norm2.bias", (d,), "bias"),
                  (f"{b}.mlp.mlp_up.weight", (m, d), "fan_in"),
                  (f"{b}.mlp.mlp_up.bias", (m,), "bias"),
                  (f"{b}.mlp.mlp_down.weight", (d, m), "fan_in"),
                  (f"{b}.mlp.mlp_down.bias", (d,), "bias")]
    specs += [("final_norm.weight", (d,), "scale"),
              ("final_norm.bias", (d,), "bias"),
              ("head.weight", (cfg["num_classes"], d), "fan_in"),
              ("head.bias", (cfg["num_classes"],), "bias")]
    return specs


def _linear(x, p, name, mode):
    return F.linear(operand(x, mode), operand(p[f"{name}.weight"], mode),
                    p[f"{name}.bias"])


def _ln(x, p, name, eps):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"],
                        p[f"{name}.bias"], eps)


def features(p, images, cfg, mode="fp32"):
    """NHWC float images -> the final-normed class token (B, hidden)."""
    eps, heads = cfg["layer_norm_eps"], cfg["num_attention_heads"]
    x = F.conv2d(operand(images.permute(0, 3, 1, 2), mode),
                 operand(p["patch_embedding.weight"], mode),
                 p["patch_embedding.bias"], stride=cfg["patch_size"])
    x = x.flatten(2).transpose(1, 2)
    b, _, d = x.shape
    x = torch.cat([p["cls"].expand(b, 1, d), x], dim=1) + p["pos_embedding"]
    hd = d // heads
    for i in range(cfg["num_hidden_layers"]):
        blk = f"block{i}"
        h = _ln(x, p, f"{blk}.norm1", eps)
        q, k, v = (_linear(h, p, f"{blk}.attn.{n}", mode)
                   .reshape(b, -1, heads, hd) for n in ("query", "key", "value"))
        s = torch.einsum("bqhd,bkhd->bhqk", operand(q / math.sqrt(hd), mode),
                         operand(k, mode))
        a = torch.einsum("bhqk,bkhd->bqhd", operand(torch.softmax(s, -1), mode),
                         operand(v, mode))
        x = x + _linear(a.reshape(b, -1, d), p, f"{blk}.attn.out", mode)
        h = _ln(x, p, f"{blk}.norm2", eps)
        h = F.gelu(_linear(h, p, f"{blk}.mlp.mlp_up", mode), approximate="tanh")
        x = x + _linear(h, p, f"{blk}.mlp.mlp_down", mode)
    return _ln(x, p, "final_norm", eps)[:, 0]


def forward(p, images, cfg, mode="fp32"):
    """NHWC float images -> (logits, pool)."""
    pool = features(p, images, cfg, mode)
    return _linear(pool, p, "head", mode), pool
