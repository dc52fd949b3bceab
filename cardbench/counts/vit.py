"""Forward FLOPs of one ViT image (``reference/vit.py``'s family), counted
as :mod:`cardbench.counts.flops` says."""


def forward(cfg, image_size: int) -> int:
    d, m, p = cfg["hidden_size"], cfg["intermediate_size"], cfg["patch_size"]
    patches = (image_size // p) ** 2
    n = patches + 1
    flops = 2 * p * p * cfg["in_channels"] * d * patches
    per_layer = (4 * 2 * n * d * d          # q, k, v and the output
                 + 2 * 2 * n * n * d        # scores and the weighted sum
                 + 2 * 2 * n * d * m)       # the MLP
    flops += cfg["num_hidden_layers"] * per_layer
    return flops + 2 * d * cfg["num_classes"]
