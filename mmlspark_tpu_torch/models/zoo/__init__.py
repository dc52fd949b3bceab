"""Model zoo registry: architecture name -> constructor.

The port's counterpart of ``mmlspark_tpu/models/zoo/__init__.py``: every
architecture registers under the same stable name with the same spec dict
(``module``, ``input_shape``, ``feature_layer``, ``feature_dim``,
``layer_names``), so stages and saved state name models the same way in
both packages. ``module`` is an ``nn.Module`` whose parameters are
allocated but not initialized; :func:`init_state` fills a state dict from a
seed. Registered: the ResNets, the tabular MLP, TextCNN, the
transformer LM and its MoE variant, the ViTs and the DLRM recommender, in
both packages; V-MoE (``vmoe_b16``, ``vmoe_tiny``) in the port alone.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import numpy as np
import torch

_ZOO: Dict[str, Callable] = {}
# architectures of the port alone, which the JAX package does not register
_PORT_ONLY: set = set()


def register_model(name: str, port_only: bool = False):
    def wrap(fn):
        _ZOO[name] = fn
        if port_only:
            _PORT_ONLY.add(name)
        return fn
    return wrap


def build_model(name: str, **kwargs):
    if name not in _ZOO:
        raise KeyError(f"unknown architecture {name!r}; have {sorted(_ZOO)}")
    return _ZOO[name](**kwargs)


def available_models() -> List[str]:
    return sorted(_ZOO)


def shared_models() -> List[str]:
    """The architectures the JAX package registers too, under the same
    names and specs (every one but V-MoE's)."""
    return sorted(set(_ZOO) - _PORT_ONLY)


def resolve_dtype(dtype) -> torch.dtype:
    """A model constructor's ``dtype`` argument: a torch dtype, or its name
    (``"float32"``, ``"bfloat16"``) as saved stages carry it."""
    if isinstance(dtype, torch.dtype):
        return dtype
    resolved = getattr(torch, str(dtype), None)
    if not isinstance(resolved, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return resolved


def _truncated_lecun(shape, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal``: a unit normal truncated to [-2, 2], scaled so
    that its standard deviation is ``sqrt(1 / fan_in)``."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    # stddev of a unit normal truncated to [-2, 2] is 0.8796...
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    u = lo + (1.0 - 2.0 * lo) * torch.rand(shape, generator=gen)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return z.clamp(-2.0, 2.0) * std


def init_state(module: torch.nn.Module, seed: int = 0) -> Dict[str, np.ndarray]:
    """A fresh state dict for ``module`` (numpy, the port's state layout),
    drawn from a ``torch.Generator`` seeded with ``seed``, with flax's
    default initializers, chosen by parameter name:

    - conv and dense ``weight``s: lecun-normal (truncated at two standard
      deviations, ``fan_in`` = every axis but the output one);
    - the MoE ``experts_up``/``experts_down`` (E, D, H)/(E, H, D):
      lecun-normal over the whole array, ``fan_in`` = every axis but the
      last, as flax's ``variance_scaling`` counts a rank-3 kernel; a bank
      whose module sets ``per_expert_fan_in`` (V-MoE's) takes each
      expert's own fan-in, D for ``experts_up`` and H for ``experts_down``;
    - ``Embed``'s ``embedding`` (V, D): ``variance_scaling(1.0, "fan_in",
      "normal", out_axis=0)``, an untruncated normal of variance 1 / D;
      the DLRM's ``<table>_embedding`` (rows, D): ``normal(D ** -0.5)``,
      the same draw;
    - ``pos_embedding``: ``normal(0.02)``;
    - norm weights one; biases and everything else (ViT's ``cls``) zero.

    The draws differ from ``jax.random``'s for the same seed; tests that
    need both packages to score the same weights pass the JAX parameters
    through :func:`mmlspark_tpu_torch.models.convert.from_jax_params`."""
    gen = torch.Generator().manual_seed(int(seed))
    per_expert = {f"{path}.{leaf}" if path else leaf
                  for path, sub in module.named_modules()
                  if getattr(sub, "per_expert_fan_in", False)
                  for leaf in ("experts_up", "experts_down")}
    state = {}
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("experts_up", "experts_down"):
            fan_in = p.shape[1] if name in per_expert \
                else math.prod(p.shape[:-1])
            value = _truncated_lecun(p.shape, fan_in, gen)
        elif leaf == "embedding" or (leaf.endswith("_embedding")
                                     and leaf != "pos_embedding"
                                     and p.ndim == 2):
            value = torch.randn(p.shape, generator=gen) \
                * math.sqrt(1.0 / p.shape[1])
        elif leaf == "pos_embedding":
            value = torch.randn(p.shape, generator=gen) * 0.02
        elif leaf == "weight" and p.ndim >= 2:
            value = _truncated_lecun(p.shape, math.prod(p.shape[1:]), gen)
        elif leaf == "weight":
            value = torch.ones(p.shape)
        else:
            value = torch.zeros(p.shape)
        state[name] = value.numpy()  # lint: allow-sync (host init draw)
    return state


class PooledHead(torch.nn.Module):
    """Base of the zoo modules: ``forward_features`` yields the ``pool``
    layer and ``head`` maps it to the output, the two names every spec's
    ``layer_names`` lists."""

    # the JAX package's sown names -> this module's intermediates keys
    SOWN = {"pool": "pool", "head": "head"}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.forward_features(x))

    def forward_with_intermediates(self, x: torch.Tensor, layers=None):
        """``(output, {"pool": features, "head": output})``. ``layers`` (the
        names the caller will read) is accepted for the zoo's common
        signature; the head is cheap, so both are always computed."""
        pool = self.forward_features(x)
        out = self.head(pool)
        return out, {"pool": pool, "head": out}



# ---------------------------------------------------------------------------
# Capturing any node's output (the JAX package's ``capture_all``)
#
# The JAX package names a submodule's output ``<flax path>/out`` (flax's
# ``__call__`` rewritten to ``out``), the root's ``out``, and adds the sown
# layers (``pool``, ``hidden``) and ``head`` (the output). The port's
# modules carry the flax module names, so ``named_modules()`` with ``.`` ->
# ``/`` rebuilds the same keys; containers and modules that a class marks
# ``flax_module = False`` have no flax counterpart and are left out.
# A module whose output layout differs from flax's (NCHW convs, a
# flattened patch grid, fused heads) restates it in its
# ``to_reference_layout(args, y)``.


def reference_layout(module: torch.nn.Module, args, y):
    """``y``, the output of ``module`` on ``args``, in the JAX package's
    layout (NHWC where the port computes NCHW), whole: a column-split
    Dense of a tensor-split block (``split_columns``, its group) computed
    the rank's features, gathered here over the group."""
    group = getattr(module, "split_columns", None)
    if group is not None:
        from mmlspark_tpu_torch.parallel import collectives
        y = collectives.all_gather(y, y.dim() - 1, group)
    fn = getattr(module, "to_reference_layout", None)
    return fn(args, y) if fn is not None else y


def capture_names(module: torch.nn.Module) -> Dict[str, object]:
    """The JAX package's capture-all keys of ``module`` -> the submodule
    whose first output each names, or the key of a sown layer in
    ``forward_with_intermediates``' dict (a ``str``)."""
    names: Dict[str, object] = dict(getattr(module, "SOWN", {}))
    for name, sub in module.named_modules():
        if isinstance(sub, (torch.nn.ModuleList, torch.nn.ModuleDict,
                            torch.nn.Sequential)) \
                or not getattr(sub, "flax_module", True):
            continue
        names[name.replace(".", "/") + "/out" if name else "out"] = sub
    return names


def select(names, node: str) -> List[str]:
    """The reference's node match: the key itself, or a key ending in
    ``/node``, in sorted order (the first is the one read)."""
    return [k for k in sorted(names) if k == node or k.endswith("/" + node)]


def _not_found(node: str, names) -> Exception:
    from mmlspark_tpu_torch.core.schema import SchemaError
    return SchemaError(f"output node {node!r} not found; have {sorted(names)}")


def node_forward(module: torch.nn.Module, node: str) -> Callable:
    """``forward(x)`` -> the output the JAX package scores for ``node``:
    a sown layer from ``forward_with_intermediates``, any other node by a
    forward hook on the one submodule :func:`select` picks (its first call,
    as flax keeps the first of a module's outputs), in the reference's
    layout and dtype. An unknown node raises ``SchemaError``."""
    names = capture_names(module)
    matches = select(names, node)
    if not matches:
        raise _not_found(node, names)
    target = names[matches[0]]
    if isinstance(target, str):
        return lambda x: module.forward_with_intermediates(
            x, layers=(target,))[1][target]

    def forward(x):
        seen = []

        def hook(mod, args, out):
            if not seen:
                seen.append(reference_layout(mod, args, out))

        handle = target.register_forward_hook(hook)
        try:
            module(x)
        finally:
            handle.remove()
        if not seen:
            from mmlspark_tpu_torch.core.schema import SchemaError
            raise SchemaError(f"output node {node!r} ({matches[0]}) was "
                              "not computed by this forward")
        return seen[0]
    return forward


def apply_with_intermediates(module: torch.nn.Module, x,
                             capture_all: bool = False):
    """``(output, {name: activation})`` under the JAX package's names: the
    sown layers and ``head``; with ``capture_all`` also every submodule's
    first output (``<path>/out``) and the root's ``out``."""
    names = capture_names(module)
    seen: Dict[str, object] = {}
    handles = []
    if capture_all:
        for key, sub in names.items():
            if isinstance(sub, str) or key == "out":
                continue

            def hook(mod, args, out, key=key):
                if key not in seen:
                    seen[key] = reference_layout(mod, args, out)
            handles.append(sub.register_forward_hook(hook))
    try:
        out, sown = module.forward_with_intermediates(x)
    finally:
        for h in handles:
            h.remove()
    inters = {ref: sown[own] for ref, own in
              getattr(module, "SOWN", {}).items()}
    if capture_all:
        inters.update(seen)
        inters["out"] = out
    return out, inters


# populate the registry
from mmlspark_tpu_torch.models.zoo import resnet as _resnet  # noqa: E402,F401
from mmlspark_tpu_torch.models.zoo import mlp as _mlp  # noqa: E402,F401
from mmlspark_tpu_torch.models.zoo import cnn1d as _cnn1d  # noqa: E402,F401
from mmlspark_tpu_torch.models.zoo import vit as _vit  # noqa: E402,F401
from mmlspark_tpu_torch.models.zoo import transformer as _transformer  # noqa: E402,F401
from mmlspark_tpu_torch.models.zoo import moe as _moe  # noqa: E402,F401
from mmlspark_tpu_torch.embed import model as _recommender  # noqa: E402,F401
