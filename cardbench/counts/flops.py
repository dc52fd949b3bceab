"""Forward FLOPs of one image, counted from shapes: two per multiply-add of
every conv and matmul (the convention ``FlopCounterMode`` follows), nothing
for norms, activations, softmax or pooling. A training step counts three
forwards, the usual model-FLOPs convention. Each architecture family
counts its own in ``counts/<family>.py``."""
from cardbench.counts.resnet import forward as resnet_forward  # noqa: F401
from cardbench.counts.vit import forward as vit_forward  # noqa: F401
from cardbench.harness import family_module


def forward(cfg, image_size: int = None) -> int:
    """Forward FLOPs of one image of ``cfg``'s architecture family."""
    size = image_size or cfg["image_size"]
    return family_module("counts", cfg).forward(cfg, size)


def train_step(cfg, images: int, image_size: int = None) -> int:
    """FLOPs of a training step over ``images`` images: 3 forwards."""
    return 3 * forward(cfg, image_size) * images
