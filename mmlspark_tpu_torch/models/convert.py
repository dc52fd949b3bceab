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

The pretrained-weight import, the port of
``mmlspark_tpu/models/convert.py``, brings a trained checkpoint into a
model repository (``models/downloader.py``) in the repository's format,
the flax tree:

- :func:`from_flax_msgpack` / :func:`to_flax_msgpack`: flax's msgpack
  checkpoint, read and written by the port's own codec
  (``models/_msgpack.py``: no flax, no msgpack package), byte for byte
  flax's;
- :func:`from_torch_npz`: a torch ``state_dict`` exported as npz (or a
  dict of numpy arrays), with the reference's leaf rules: ``weight`` of
  rank 2 -> ``kernel`` transposed, rank 4 OIHW -> HWIO, rank 3 (out, in,
  k) -> (k, in, out), rank 1 -> ``scale``; ``running_mean`` /
  ``running_var`` -> ``mean`` / ``var``; ``num_batches_tracked`` dropped;
- :func:`validate_params`: leaf paths and shapes against the zoo
  module of the architecture, built on the meta device (no weight is
  drawn or allocated) and laid out as :func:`to_jax_params` lays out a
  state dict; every mismatch listed;
- :func:`import_pretrained`: validate, then ``LocalRepo.save_model``
  with the schema filled from the zoo spec.
"""
from __future__ import annotations

import os
from collections.abc import Mapping
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from mmlspark_tpu_torch.models import _msgpack
from mmlspark_tpu_torch.models.downloader import LocalRepo, ModelSchema


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
    for path, out in _reference_leaves(state, module):
        _put(tree, path, np.array(out, order="C"))
    return {"params": tree}


def _reference_leaves(state: Mapping, module):
    """``(flax path, array)`` of each state dict entry in the JAX
    package's layout (views where numpy can give them)."""
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
        yield path[:-1] + [new_leaf], out


def _put(tree: Dict[str, Any], path, value) -> None:
    node = tree
    for part in path[:-1]:
        node = node.setdefault(part, {})
    node[path[-1]] = value


# -- flax msgpack ------------------------------------------------------------

def from_flax_msgpack(source: Union[str, bytes]) -> Dict[str, Any]:
    """Restore a flax msgpack checkpoint (path or raw bytes) into a plain
    nested dict of numpy arrays."""
    if isinstance(source, (str, os.PathLike)):
        with open(source, "rb") as f:
            source = f.read()
    return _to_numpy(_msgpack.restore(source))


def to_flax_msgpack(params: Any, path: Optional[str] = None) -> bytes:
    """Serialize a param tree to flax msgpack bytes (optionally saved)."""
    data = _msgpack.serialize(_to_numpy(params))
    if path is not None:
        with open(path, "wb") as f:
            f.write(data)
    return data


def _to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


# -- torch state_dict (npz container) ----------------------------------------

_TORCH_DROP = ("num_batches_tracked",)


def _convert_torch_leaf(leaf_name: str, arr: np.ndarray
                        ) -> Optional[Tuple[str, np.ndarray]]:
    """(flax leaf name, re-laid-out array) for one torch tensor, or None
    for bookkeeping tensors that have no flax counterpart."""
    if leaf_name in _TORCH_DROP:
        return None
    if leaf_name == "weight":
        if arr.ndim == 2:          # Linear (out, in) -> kernel (in, out)
            return "kernel", arr.T
        if arr.ndim == 4:          # Conv2d OIHW -> HWIO
            return "kernel", arr.transpose(2, 3, 1, 0)
        if arr.ndim == 3:          # Conv1d (out, in, k) -> (k, in, out)
            return "kernel", arr.transpose(2, 1, 0)
        return "scale", arr        # norm layers keep 1-D weight as scale
    if leaf_name == "running_mean":
        return "mean", arr
    if leaf_name == "running_var":
        return "var", arr
    return leaf_name, arr          # bias and friends pass through


def from_torch_npz(source: Union[str, Dict[str, np.ndarray]]
                   ) -> Dict[str, Any]:
    """Torch ``state_dict`` (exported as npz, or an in-memory dict of
    numpy arrays) -> flax-style nested params under ``{"params": ...}``.

    The dotted torch key path becomes the flax module nesting verbatim
    (the port's zoo modules carry the flax names, so a port state dict
    exported with ``.numpy()`` converts); only the LEAF name and layout
    are translated."""
    if isinstance(source, (str, os.PathLike)):
        with np.load(source, allow_pickle=False) as z:
            flat = {k: np.asarray(z[k]) for k in z.files}
    else:
        flat = {k: np.asarray(v) for k, v in source.items()}
    tree: Dict[str, Any] = {}
    for key, arr in flat.items():
        parts = key.split(".")
        converted = _convert_torch_leaf(parts[-1], arr)
        if converted is None:
            continue
        leaf, value = converted
        _put(tree, parts[:-1] + [leaf], value)
    return {"params": tree}


# -- validation + publishing -------------------------------------------------

def _flat_leaves(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat_leaves(v, f"{prefix}{k}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _meta_spec(architecture: str, arch_kwargs: Dict[str, Any]):
    """The zoo spec of ``architecture`` with its module on the meta
    device: shapes and dtypes, no storage."""
    from mmlspark_tpu_torch.models.zoo import build_model
    with torch.device("meta"):
        return build_model(architecture, **arch_kwargs)


def _target(module: torch.nn.Module) -> Dict[str, Tuple[Tuple, np.dtype]]:
    """``{flax path: (shape, dtype)}`` of ``module``'s parameters in the
    JAX package's layout: :func:`to_jax_params`'s rules applied to
    zero-stride stand-ins of each parameter's shape, so a meta module
    gives the target without allocating its weights."""
    stand_ins = {
        name: np.broadcast_to(
            np.zeros((), np.dtype(str(p.dtype).replace("torch.", ""))),
            tuple(p.shape))
        for name, p in module.named_parameters()}
    return {"/".join(["params"] + path): (tuple(out.shape), out.dtype)
            for path, out in _reference_leaves(stand_ins, module)}


def validate_params(architecture: str, params: Any, _spec=None,
                    **arch_kwargs) -> Dict[str, Any]:
    """Check an imported tree against ``architecture``'s parameters (leaf
    paths in flax naming, and shapes). Returns the params as numpy arrays
    cast to the parameters' dtypes; raises ValueError listing every
    mismatch otherwise."""
    spec = _spec if _spec is not None else _meta_spec(architecture,
                                                      arch_kwargs)
    target = _target(spec["module"])
    got = {k: tuple(np.shape(v))
           for k, v in _flat_leaves(_to_numpy(params)).items()}
    want = {k: shape for k, (shape, _) in target.items()}
    missing = sorted(set(want) - set(got))
    unexpected = sorted(set(got) - set(want))
    wrong = sorted(k for k in set(want) & set(got) if want[k] != got[k])
    if missing or unexpected or wrong:
        raise ValueError(
            f"params do not match architecture {architecture!r}:\n"
            f"  missing: {missing}\n  unexpected: {unexpected}\n"
            f"  shape mismatches: "
            f"{[(k, got[k], want[k]) for k in wrong]}")
    # cast to the parameter dtypes (e.g. a float64 numpy export -> float32)

    def cast(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: cast(v, f"{prefix}{k}/") for k, v in tree.items()}
        return np.asarray(tree, dtype=target[prefix.rstrip("/")][1])
    return cast(_to_numpy(params))


def import_pretrained(repo: LocalRepo, name: str, architecture: str,
                      params: Any, dataset: str = "",
                      input_mean: Optional[List[float]] = None,
                      input_std: Optional[List[float]] = None,
                      **arch_kwargs) -> ModelSchema:
    """Validate ``params`` against ``architecture`` and publish them into
    ``repo`` with a complete ModelSchema (layerNames from the zoo spec,
    the reference's transfer-learning contract; ``input_mean`` /
    ``input_std`` record the normalization the net was trained with).
    Returns the written schema."""
    spec = _meta_spec(architecture, arch_kwargs)
    params = validate_params(architecture, params, _spec=spec, **arch_kwargs)
    layer_names: List[str] = list(spec.get("layer_names", []))
    schema = ModelSchema(
        name=name, architecture=architecture, dataset=dataset,
        inputNode=spec.get("feature_layer", ""),
        numLayers=len(layer_names), layerNames=layer_names,
        architectureArgs=dict(arch_kwargs),
        inputMean=[float(v) for v in (input_mean or [])],
        inputStd=[float(v) for v in (input_std or [])])
    return repo.save_model(schema, params)
