"""JAX-package parameter trees -> the port's state dicts.

The inverse of the reference's torch import
(``mmlspark_tpu/models/convert.py::_convert_torch_leaf``): a flax tree
``{"params": {module: {leaf: array}}}`` becomes a flat state dict whose
keys are the module path joined by dots. Only the leaf is translated:

- conv ``kernel`` HWIO -> ``weight`` OIHW;
- dense ``kernel`` (in, out) -> ``weight`` (out, in);
- the ``DenseGeneral`` kernels of flax's multi-head attention (ViT):
  ``query``/``key``/``value`` (in, heads, head_dim) -> ``weight``
  (heads * head_dim, in) with their (heads, head_dim) ``bias`` flattened,
  and ``out`` (heads, head_dim, out) -> ``weight`` (out, heads * head_dim);
- norm ``scale`` -> ``weight``; ``bias`` and others (``embedding``,
  ``pos_embedding``, ``cls``, the MoE ``experts_up`` (E, D, H) and
  ``experts_down`` (E, H, D)) pass through.

The port's zoo modules carry the flax submodule names, so the result loads
with ``load_state_dict(strict=True)``. Leaves may be numpy arrays or
anything ``np.asarray`` accepts; nothing here imports JAX.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Tuple

import numpy as np


# flax MultiHeadDotProductAttention's DenseGeneral projections: these take
# (in, heads, head_dim) kernels, and "out" a (heads, head_dim, out) one
_HEAD_SPLIT_IN = ("query", "key", "value")


def _convert_leaf(module: str, leaf: str,
                  arr: np.ndarray) -> Tuple[str, np.ndarray]:
    if leaf == "kernel":
        if arr.ndim == 4:
            return "weight", arr.transpose(3, 2, 0, 1)
        if arr.ndim == 2:
            return "weight", arr.T
        if arr.ndim == 3 and module in _HEAD_SPLIT_IN:
            return "weight", arr.reshape(arr.shape[0], -1).T
        if arr.ndim == 3 and module == "out":
            return "weight", arr.reshape(-1, arr.shape[-1]).T
        raise ValueError(f"kernel of rank {arr.ndim} has no torch layout")
    if leaf == "bias" and arr.ndim == 2 and module in _HEAD_SPLIT_IN:
        return "bias", arr.reshape(-1)
    if leaf == "scale":
        return "weight", arr
    return leaf, arr


def from_jax_params(tree: Mapping) -> Dict[str, np.ndarray]:
    """Flax parameter tree (with or without the ``"params"`` collection
    key) -> the port's state dict of contiguous numpy arrays, copied, so
    the result is writable and shares no memory with the tree. Covers
    every leaf the zoo holds: the ResNets, the MLP, the transformer LM
    and its MoE variant, and the ViTs."""
    if "params" in tree:
        tree = tree["params"]
    out: Dict[str, np.ndarray] = {}

    def walk(prefix: str, node: Any) -> None:
        module = prefix[:-1].rsplit(".", 1)[-1]
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(f"{prefix}{key}.", value)
            else:
                name, arr = _convert_leaf(module, key, np.asarray(value))
                out[prefix + name] = np.array(arr, order="C")
    walk("", tree)
    return out
