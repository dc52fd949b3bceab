"""JAX-package parameter trees -> the port's state dicts.

The inverse of the reference's torch import
(``mmlspark_tpu/models/convert.py::_convert_torch_leaf``): a flax tree
``{"params": {module: {leaf: array}}}`` becomes a flat state dict whose
keys are the module path joined by dots. Only the leaf is translated:

- conv ``kernel`` HWIO -> ``weight`` OIHW;
- dense ``kernel`` (in, out) -> ``weight`` (out, in);
- norm ``scale`` -> ``weight``; ``bias`` and others pass through.

The port's zoo modules carry the flax submodule names, so the result loads
with ``load_state_dict(strict=True)``. Leaves may be numpy arrays or
anything ``np.asarray`` accepts; nothing here imports JAX.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Tuple

import numpy as np


def _convert_leaf(leaf: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    if leaf == "kernel":
        if arr.ndim == 4:
            return "weight", arr.transpose(3, 2, 0, 1)
        if arr.ndim == 2:
            return "weight", arr.T
        raise ValueError(f"kernel of rank {arr.ndim} has no torch layout")
    if leaf == "scale":
        return "weight", arr
    return leaf, arr


def from_jax_params(tree: Mapping) -> Dict[str, np.ndarray]:
    """Flax parameter tree (with or without the ``"params"`` collection
    key) -> the port's state dict of contiguous numpy arrays, copied, so
    the result is writable and shares no memory with the tree. Covers
    every leaf the zoo holds: the convs and GroupNorms of the ResNets and
    the Dense layers of the ResNet head and of the MLP."""
    if "params" in tree:
        tree = tree["params"]
    out: Dict[str, np.ndarray] = {}

    def walk(prefix: str, node: Any) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(f"{prefix}{key}.", value)
            else:
                name, arr = _convert_leaf(key, np.asarray(value))
                out[prefix + name] = np.array(arr, order="C")
    walk("", tree)
    return out
