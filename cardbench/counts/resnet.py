"""Forward FLOPs of one ResNet image (``reference/resnet.py``'s family),
counted as :mod:`cardbench.counts.flops` says."""


def _conv_out(size: int, stride: int) -> int:
    return -(-size // stride)


def forward(cfg, image_size: int) -> int:
    w, exp, k = cfg["width"], cfg["bottleneck_expansion"], cfg["stem_kernel"]
    h = (image_size + 2 * (k // 2) - k) // 2 + 1
    flops = 2 * k * k * cfg["in_channels"] * w * h * h
    h = _conv_out(h, 2)                       # the SAME 3x3/2 max-pool
    cin = w
    for i, n in enumerate(cfg["stage_sizes"]):
        f = w * 2 ** i
        for j in range(n):
            stride = 2 if i > 0 and j == 0 else 1
            ho = _conv_out(h, stride)
            flops += 2 * cin * f * h * h            # 1x1
            flops += 2 * 9 * f * f * ho * ho        # 3x3, strided
            flops += 2 * f * f * exp * ho * ho      # 1x1
            if stride != 1 or cin != f * exp:
                flops += 2 * cin * f * exp * ho * ho  # projection
            cin, h = f * exp, ho
    return flops + 2 * cin * cfg["num_classes"]
