"""Counts of one V-MoE training step (``reference/vmoe.py``'s family):
the forward FLOPs of an image, as :mod:`cardbench.counts.flops` says
(every routed pair counted, the model FLOPs convention), and the work of
its two new layers from shapes: the experts' GEMMs over every routed
(token, choice) pair, and the least bytes of the dispatch's row moves."""
from cardbench.counts import vit


def _tokens(cfg, image_size: int) -> int:
    return (image_size // cfg["patch_size"]) ** 2 + 1


def forward(cfg, image_size: int) -> int:
    """ViT's count, plus in each routed block the router (D -> E) and
    K - 1 more MLPs a token (a dense block counts one)."""
    d, m = cfg["hidden_size"], cfg["intermediate_size"]
    n = _tokens(cfg, image_size)
    extra = (2 * 2 * n * d * m * (cfg["experts_per_token"] - 1)
             + 2 * n * d * cfg["num_experts"])
    return vit.forward(cfg, image_size) + len(cfg["moe_layers"]) * extra


def expert_gemm_flops(cfg, images: int) -> int:
    """FLOPs of the experts' GEMMs in training steps over ``images``:
    12 S K D H a routed block (forward, input gradient and weight
    gradient of up and down, 2 S K D H each), over every routed pair. A
    pair past its expert's capacity is dropped, so this is an upper bound
    on the pairs kept; an implementation that computes each expert's
    capacity buffer whole does round(K S c / E) E >= S K rows' work."""
    s = images * _tokens(cfg, cfg["image_size"])
    return (len(cfg["moe_layers"]) * 12 * s * cfg["experts_per_token"]
            * cfg["hidden_size"] * cfg["intermediate_size"])


def permute_bytes(cfg, images: int) -> int:
    """Least HBM bytes of the dispatch's row moves in training steps over
    ``images``, whatever the routing: every token row, and every pair's
    slot (int32) and gate (float32), once a pass. The token rows and their
    gradient are the float32 LayerNorm's (4 B), the combined output and its
    gradient in the compute dtype (2 B). Forward: the gather reads the
    token rows, the combine writes them; backward: the combine's reads the
    output gradient, reads the gates and writes theirs, the gather's writes
    the token gradient. The expert rows of the kept pairs (2 B each way)
    are left out: how many pairs are kept depends on the routing (any may
    be dropped at capacity), so the count holds for every routing."""
    s = images * _tokens(cfg, cfg["image_size"])
    pairs = s * cfg["experts_per_token"]
    d = cfg["hidden_size"]
    per_block = (2 * s * d * 4            # gather in, its gradient out
                 + 2 * s * d * 2          # combine out, its gradient in
                 + 3 * pairs * 4          # gates, and their gradient
                 + 4 * pairs * 4)         # the slots, each pass
    return len(cfg["moe_layers"]) * per_block
