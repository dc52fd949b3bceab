"""V-MoE-B/16 (Riquelme et al. 2021, arXiv:2106.05974): ViT-B/16 whose
blocks ``moe_layers`` ("Every-2": 1, 3, 5, 7, 9, 11) replace the MLP by
``num_experts`` expert MLPs (hidden -> intermediate -> hidden, with
biases, tanh GELU), each token routed to ``experts_per_token`` of them.
The dense parts are ``reference/vit.py``'s. Parameter names follow the
port's state dict.

Routing, per the paper's section 2 and appendix A, over the whole batch
as one group of S tokens:

- gates: the top K of ``softmax(W x + eps)``, not renormalised; the
  router ``W`` (E, D) has no bias; in training ``eps ~ N(0, sigma^2)``,
  ``sigma = router_noise_std / E``;
- capacity: ``round(K * S * capacity_factor / E)`` slots an expert, taken
  by every first choice in token order, then every second choice; a
  choice past its expert's capacity is dropped (the token keeps its
  residual);
- auxiliary loss: ``(L_imp + L_load) / 2``, each the squared coefficient
  of variation (population) over experts: of the importance, the sum over
  tokens of the softmax, and of the load, the sum over tokens of ``P(
  expert i stays in the top K when its noise is drawn again) = 1 -
  Phi((eta_K - (W x)_i) / sigma)``, ``eta_K`` the K-th largest noisy logit.

Departures from the paper (the configuration's ``assumed``): the group
is the whole batch, where the paper routes each device's share; the
noise is a ``torch.Generator`` draw on the images' device seeded with
``router_noise_seed * 65536 + block``, the same draw at every step, so
the program's and this reference's runs draw the same; ``eta_K`` is the
K-th largest noisy logit for every expert, the selected ones included, as
the authors' code has it.

Each expert runs on the rows gathered to it, in a loop; nothing of shape
(S, E, C) is built."""
import math

import torch
import torch.nn.functional as F

from cardbench.reference.precision import operand
from cardbench.reference.vit import _linear, _ln
from cardbench.reference.vit import param_specs as vit_specs

_MLP = (".mlp.mlp_up.weight", ".mlp.mlp_up.bias", ".mlp.mlp_down.weight",
        ".mlp.mlp_down.bias")


def param_specs(cfg):
    d, h, e = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_experts"]
    moe = {f"block{i}" for i in cfg["moe_layers"]}
    specs = []
    for spec in vit_specs(cfg):
        name = spec[0]
        block = name.split(".", 1)[0]
        if block not in moe or not name.endswith(_MLP):
            specs.append(spec)
        elif name.endswith(_MLP[0]):
            m = f"{block}.mlp"
            specs += [(f"{m}.router.weight", (e, d), "fan_in"),
                      (f"{m}.experts_up", (e, d, h), "fan_in", d),
                      (f"{m}.experts_up_bias", (e, h), "bias"),
                      (f"{m}.experts_down", (e, h, d), "fan_in", h),
                      (f"{m}.experts_down_bias", (e, d), "bias")]
    return specs


def noise(shape, cfg, block: int, device) -> torch.Tensor:
    """The router noise of block ``block``: a unit normal draw from a
    generator on ``device`` seeded with ``router_noise_seed * 65536 +
    block``, times ``router_noise_std / E``."""
    gen = torch.Generator(device=device).manual_seed(
        int(cfg["router_noise_seed"]) * 65536 + block)
    eps = torch.randn(shape, generator=gen, device=device)
    return (cfg["router_noise_std"] / cfg["num_experts"]) * eps


def _cv_squared(v):
    mean = v.mean()
    return ((v - mean) ** 2).mean() / mean ** 2


def routed_mlp(p, name, x, cfg, block, mode, train, record=None):
    """x (S, D) -> (y (S, D), aux): the routed MLP of block ``block``."""
    e_count, k_top = cfg["num_experts"], cfg["experts_per_token"]
    s_tokens = x.shape[0]
    logits = F.linear(operand(x, mode), operand(p[f"{name}.router.weight"],
                                                 mode))
    sigma = cfg["router_noise_std"] / e_count
    noisy = logits + noise(logits.shape, cfg, block, x.device) if train \
        else logits
    probs = torch.softmax(noisy, dim=-1)
    gate, idx = torch.topk(probs, k_top, dim=-1)
    eta = torch.topk(noisy, k_top, dim=-1).values[:, -1:]
    load = (1.0 - torch.special.ndtr((eta - logits) / sigma)).sum(dim=0)
    aux = 0.5 * (_cv_squared(probs.sum(dim=0)) + _cv_squared(load))
    cap = round(k_top * s_tokens * cfg["capacity_factor"] / e_count)
    y = torch.zeros_like(x)
    dropped = 0
    for e in range(e_count):
        taken, rows, gates = 0, [], []
        for k in range(k_top):
            mine = (idx[:, k] == e).nonzero().flatten()
            kept = mine[:max(0, cap - taken)]
            taken += len(mine)
            dropped += len(mine) - len(kept)
            rows.append(kept)
            gates.append(gate[kept, k])
        rows, gates = torch.cat(rows), torch.cat(gates)
        if not len(rows):
            continue
        hid = F.gelu(operand(x[rows], mode) @ operand(
            p[f"{name}.experts_up"][e], mode) + p[f"{name}.experts_up_bias"][e],
            approximate="tanh")
        out = operand(hid, mode) @ operand(p[f"{name}.experts_down"][e], mode) \
            + p[f"{name}.experts_down_bias"][e]
        y = y.index_add(0, rows, gates[:, None] * out)
    if record is not None:
        record[block] = {"gate_idx": idx.detach(), "dropped": dropped,
                         "pairs": k_top * s_tokens, "capacity": cap}
    return y, aux


def forward(p, images, cfg, mode="fp32", train=True, record=None):
    """NHWC float images -> (logits, pool, aux), ``aux`` the sum over the
    routed blocks. ``train`` adds the router noise; ``record``, a dict,
    gets each routed block's expert choices and drops."""
    eps, heads = cfg["layer_norm_eps"], cfg["num_attention_heads"]
    x = F.conv2d(operand(images.permute(0, 3, 1, 2), mode),
                 operand(p["patch_embedding.weight"], mode),
                 p["patch_embedding.bias"], stride=cfg["patch_size"])
    x = x.flatten(2).transpose(1, 2)
    b, n, d = x.shape
    x = torch.cat([p["cls"].expand(b, 1, d), x], dim=1) + p["pos_embedding"]
    hd = d // heads
    aux = x.new_zeros(())
    for i in range(cfg["num_hidden_layers"]):
        blk = f"block{i}"
        h = _ln(x, p, f"{blk}.norm1", eps)
        q, k, v = (_linear(h, p, f"{blk}.attn.{t}", mode)
                   .reshape(b, -1, heads, hd) for t in ("query", "key", "value"))
        s = torch.einsum("bqhd,bkhd->bhqk", operand(q / math.sqrt(hd), mode),
                         operand(k, mode))
        a = torch.einsum("bhqk,bkhd->bqhd", operand(torch.softmax(s, -1), mode),
                         operand(v, mode))
        x = x + _linear(a.reshape(b, -1, d), p, f"{blk}.attn.out", mode)
        h = _ln(x, p, f"{blk}.norm2", eps)
        if i in cfg["moe_layers"]:
            y, layer_aux = routed_mlp(p, f"{blk}.mlp", h.reshape(-1, d), cfg,
                                      i, mode, train, record)
            x = x + y.reshape(b, -1, d)
            aux = aux + layer_aux
        else:
            h = F.gelu(_linear(h, p, f"{blk}.mlp.mlp_up", mode),
                       approximate="tanh")
            x = x + _linear(h, p, f"{blk}.mlp.mlp_down", mode)
    pool = _ln(x, p, "final_norm", eps)[:, 0]
    return _linear(pool, p, "head", mode), pool, aux
