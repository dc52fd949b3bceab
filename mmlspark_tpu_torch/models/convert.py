"""JAX-package parameter trees <-> the port's state dicts.

The inverse of the reference's torch import
(``mmlspark_tpu/models/convert.py::_convert_torch_leaf``): a flax tree
``{"params": {module: {leaf: array}}}`` becomes a flat state dict whose
keys are the module path joined by dots. Only the leaf is translated:

- conv ``kernel`` HWIO -> ``weight`` OIHW, and a 1-D conv's ``kernel``
  (k, in, out) -> ``weight`` (out, in, k) (a rank-3 kernel of a module
  named ``conv...``, as TextCNN's ``conv3``/``conv4``/``conv5`` are);
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

:func:`to_jax_params` is the inverse: a port state dict (or tensors) ->
the flax tree ``{"params": {...}}``, so a model repository written by
either package loads in the other. The attention heads of a ViT's
``DenseGeneral`` kernels are not in the state dict: they come from the
module the state belongs to.
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
        if arr.ndim == 3 and module.startswith("conv"):
            return "weight", arr.transpose(2, 1, 0)
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
    every leaf the zoo holds: the ResNets, the MLP, TextCNN, the
    transformer LM and its MoE variant, and the ViTs."""
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


def _unconvert_leaf(module: str, leaf: str, arr: np.ndarray,
                    heads) -> Tuple[str, np.ndarray]:
    if leaf == "weight":
        if arr.ndim == 1:
            return "scale", arr
        if arr.ndim == 4:
            return "kernel", arr.transpose(2, 3, 1, 0)
        if arr.ndim == 3:
            return "kernel", arr.transpose(2, 1, 0)
        if module in _HEAD_SPLIT_IN + ("out",) and heads is not None:
            if module == "out":
                return "kernel", arr.T.reshape(heads, -1, arr.shape[0])
            return "kernel", arr.T.reshape(arr.shape[1], heads, -1)
        return "kernel", arr.T
    if leaf == "bias" and module in _HEAD_SPLIT_IN and heads is not None:
        return "bias", arr.reshape(heads, -1)
    return leaf, arr


def to_jax_params(state: Mapping, module=None) -> Dict[str, Any]:
    """The port's state dict (numpy arrays or tensors) -> the JAX
    package's flax tree ``{"params": {module: {leaf: array}}}``:
    :func:`from_jax_params` inverted, so ``to_jax_params(
    from_jax_params(t), module) == t``. ``module`` (the ``nn.Module`` the
    state belongs to) gives the head count of a multi-head attention's
    ``query``/``key``/``value``/``out`` kernels; a state holding them
    without it raises."""
    tensors = {k: v for k, v in state.items() if hasattr(v, "detach")}
    if tensors:
        from mmlspark_tpu_torch.observability import syncs
        state = {**state, **syncs.device_get(
            {k: v.detach() for k, v in tensors.items()},
            "convert.to_jax_params")}
    tree: Dict[str, Any] = {}
    for key, value in state.items():
        arr = np.asarray(value)
        path = key.split(".")
        name, leaf = path[-2] if len(path) > 1 else "", path[-1]
        heads = None
        if name in _HEAD_SPLIT_IN + ("out",) and len(path) > 2:
            parent = (module.get_submodule(".".join(path[:-2]))
                      if module is not None else None)
            heads = getattr(parent, "heads", None)
            if parent is None and arr.ndim <= 2:
                raise ValueError(
                    f"{key}: a multi-head attention leaf needs the module "
                    "for its head count (to_jax_params(state, module))")
        new_leaf, out = _unconvert_leaf(name, leaf, arr, heads)
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[new_leaf] = np.array(out, order="C")
    return {"params": tree}
