"""Seeded weights, made on the device in one draw and handed over as host
arrays in the port's state-dict layout (the layout its ``set_model`` and
``DistributedTrainer.init`` take). The same arrays feed the reference.

Each leaf is a slice of one normal draw, scaled by its kind: ``fan_in``
weights by ``sqrt(1 / fan_in)``; norm ``scale``s one plus a tenth of the
draw; ``bias``es a fiftieth of it; ``embed``dings (the class token,
positions) a fiftieth. ``round_to`` rounds every leaf to the dtype the
weights are served in (bfloat16 for scoring), so the program's own cast
of them is exact."""
import math
from typing import Dict

import numpy as np
import torch

from cardbench.reference import module_for


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed per (run seed, purpose), fixed across runs."""
    h = 1469598103934665603
    for ch in f"{int(seed)}/{purpose}":
        h = ((h ^ ord(ch)) * 1099511628211) % (1 << 64)
    return h % (1 << 63)


def make(cfg, seed: int, device: torch.device,
         round_to: torch.dtype = None) -> Dict[str, np.ndarray]:
    specs = module_for(cfg).param_specs(cfg)
    total = sum(math.prod(shape) for _, shape, _ in specs)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device)
    offset = 0
    for _, shape, kind in specs:
        n = math.prod(shape)
        leaf = flat[offset:offset + n]
        if kind == "fan_in":
            leaf.mul_(math.sqrt(1.0 / math.prod(shape[1:])))
        elif kind == "scale":
            leaf.mul_(0.1).add_(1.0)
        else:
            leaf.mul_(0.02)
        offset += n
    if round_to is not None:
        flat = flat.to(round_to).float()
    host = flat.cpu().numpy()
    out, offset = {}, 0
    for name, shape, _ in specs:
        n = math.prod(shape)
        out[name] = host[offset:offset + n].reshape(shape)
        offset += n
    return out

