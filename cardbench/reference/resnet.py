"""ResNet-50 (He et al. 2015, Table 1, 50-layer), with the repo's
departures that the configuration lists under ``assumed``: GroupNorm
(``min(32, C)`` groups, eps 1e-6) after every conv, XLA SAME padding, the
stride on each downsampling block's 3x3 conv. Parameter names follow the
port's state dict (``stage{i}_block{j}.conv1.weight``, ...)."""
import torch.nn.functional as F

from cardbench.reference.precision import operand


def _same(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _blocks(cfg):
    """(name, cin, features, stride) of every bottleneck block."""
    cin, width, exp = cfg["width"], cfg["width"], cfg["bottleneck_expansion"]
    out = []
    for i, n in enumerate(cfg["stage_sizes"]):
        f = width * 2 ** i
        for j in range(n):
            out.append((f"stage{i}_block{j}", cin, f,
                        2 if i > 0 and j == 0 else 1))
            cin = f * exp
    return out


def param_specs(cfg):
    """[(name, shape, kind)]: kind is ``fan_in`` (normal, variance 1 /
    fan-in), ``scale`` (around one), ``bias`` (small)."""
    w, exp, k = cfg["width"], cfg["bottleneck_expansion"], cfg["stem_kernel"]
    specs = [("stem_conv.weight", (w, cfg["in_channels"], k, k), "fan_in"),
             ("stem_norm.weight", (w,), "scale"),
             ("stem_norm.bias", (w,), "bias")]

    def conv_norm(prefix, conv, norm, cin, cout, kk):
        specs.extend([(f"{prefix}.{conv}.weight", (cout, cin, kk, kk), "fan_in"),
                      (f"{prefix}.{norm}.weight", (cout,), "scale"),
                      (f"{prefix}.{norm}.bias", (cout,), "bias")])
    for name, cin, f, stride in _blocks(cfg):
        conv_norm(name, "conv1", "norm1", cin, f, 1)
        conv_norm(name, "conv2", "norm2", f, f, 3)
        conv_norm(name, "conv3", "norm3", f, f * exp, 1)
        if stride != 1 or cin != f * exp:
            conv_norm(name, "proj", "proj_norm", cin, f * exp, 1)
    feat = w * 2 ** (len(cfg["stage_sizes"]) - 1) * exp
    specs.extend([("head.weight", (cfg["num_classes"], feat), "fan_in"),
                  ("head.bias", (cfg["num_classes"],), "bias")])
    return specs


def _conv(x, w, stride, mode, pads=None):
    k = w.shape[-1]
    if pads is None:
        pads = (_same(x.shape[2], k, stride), _same(x.shape[3], k, stride))
    (t, b), (l, r) = pads
    if (t, b, l, r) != (0, 0, 0, 0):
        x = F.pad(x, (l, r, t, b))
    return F.conv2d(operand(x, mode), operand(w, mode), stride=stride)


def _gn(x, p, name):
    c = x.shape[1]
    return F.group_norm(x, min(32, c), p[f"{name}.weight"], p[f"{name}.bias"],
                        eps=1e-6)


def features(p, images, cfg, mode="fp32"):
    """NHWC float images -> the (B, 2048) pool layer."""
    x = images.permute(0, 3, 1, 2)
    k = cfg["stem_kernel"]
    x = _conv(x, p["stem_conv.weight"], 2, mode,
              pads=((k // 2, k // 2), (k // 2, k // 2)))
    x = F.relu(_gn(x, p, "stem_norm"))
    (t, b), (l, r) = _same(x.shape[2], 3, 2), _same(x.shape[3], 3, 2)
    x = F.max_pool2d(F.pad(x, (l, r, t, b), value=float("-inf")), 3, 2)
    exp = cfg["bottleneck_expansion"]
    for name, cin, f, stride in _blocks(cfg):
        y = F.relu(_gn(_conv(x, p[f"{name}.conv1.weight"], 1, mode), p,
                       f"{name}.norm1"))
        y = F.relu(_gn(_conv(y, p[f"{name}.conv2.weight"], stride, mode), p,
                       f"{name}.norm2"))
        y = _gn(_conv(y, p[f"{name}.conv3.weight"], 1, mode), p,
                f"{name}.norm3")
        if stride != 1 or cin != f * exp:
            x = _gn(_conv(x, p[f"{name}.proj.weight"], stride, mode), p,
                    f"{name}.proj_norm")
        x = F.relu(y + x)
    return x.mean(dim=(2, 3))


def forward(p, images, cfg, mode="fp32"):
    """NHWC float images -> (logits, pool)."""
    pool = features(p, images, cfg, mode)
    logits = F.linear(operand(pool, mode), operand(p["head.weight"], mode),
                      p["head.bias"])
    return logits, pool
