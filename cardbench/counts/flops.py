"""Forward FLOPs of one image, counted from shapes: two per multiply-add of
every conv and matmul (the convention ``FlopCounterMode`` follows), nothing
for norms, activations, softmax or pooling. A training step counts three
forwards, the usual model-FLOPs convention."""


def _conv_out(size: int, stride: int) -> int:
    return -(-size // stride)


def resnet_forward(cfg, image_size: int) -> int:
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


def vit_forward(cfg, image_size: int) -> int:
    d, m, p = cfg["hidden_size"], cfg["intermediate_size"], cfg["patch_size"]
    patches = (image_size // p) ** 2
    n = patches + 1
    flops = 2 * p * p * cfg["in_channels"] * d * patches
    per_layer = (4 * 2 * n * d * d          # q, k, v and the output
                 + 2 * 2 * n * n * d        # scores and the weighted sum
                 + 2 * 2 * n * d * m)       # the MLP
    flops += cfg["num_hidden_layers"] * per_layer
    return flops + 2 * d * cfg["num_classes"]


def forward(cfg, image_size: int = None) -> int:
    """Forward FLOPs of one image of ``cfg``'s architecture."""
    size = image_size or cfg["image_size"]
    fn = {"resnet50": resnet_forward, "vit_b16": vit_forward}[cfg["architecture"]]
    return fn(cfg, size)


def train_step(cfg, images: int, image_size: int = None) -> int:
    """FLOPs of a training step over ``images`` images: 3 forwards."""
    return 3 * forward(cfg, image_size) * images
