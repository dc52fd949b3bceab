"""Model zoo registry: architecture name -> constructor.

The port's counterpart of ``mmlspark_tpu/models/zoo/__init__.py``: every
architecture registers under the same stable name with the same spec dict
(``module``, ``input_shape``, ``feature_layer``, ``feature_dim``,
``layer_names``), so stages and saved state name models the same way in
both packages. ``module`` is an ``nn.Module`` whose parameters are
allocated but not initialized; :func:`init_state` fills a state dict from a
seed. Registered so far: the ResNets, the tabular MLP, the transformer LM
and its MoE variant, and the ViTs.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import numpy as np
import torch

_ZOO: Dict[str, Callable] = {}


def register_model(name: str):
    def wrap(fn):
        _ZOO[name] = fn
        return fn
    return wrap


def build_model(name: str, **kwargs):
    if name not in _ZOO:
        raise KeyError(f"unknown architecture {name!r}; have {sorted(_ZOO)}")
    return _ZOO[name](**kwargs)


def available_models() -> List[str]:
    return sorted(_ZOO)


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
      last, as flax's ``variance_scaling`` counts a rank-3 kernel;
    - ``Embed``'s ``embedding`` (V, D): ``variance_scaling(1.0, "fan_in",
      "normal", out_axis=0)``, an untruncated normal of variance 1 / D;
    - ``pos_embedding``: ``normal(0.02)``;
    - norm weights one; biases and everything else (ViT's ``cls``) zero.

    The draws differ from ``jax.random``'s for the same seed; tests that
    need both packages to score the same weights pass the JAX parameters
    through :func:`mmlspark_tpu_torch.models.convert.from_jax_params`."""
    gen = torch.Generator().manual_seed(int(seed))
    state = {}
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("experts_up", "experts_down"):
            value = _truncated_lecun(p.shape, math.prod(p.shape[:-1]), gen)
        elif leaf == "embedding":
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
        state[name] = value.numpy()
    return state


class PooledHead(torch.nn.Module):
    """Base of the zoo modules: ``forward_features`` yields the ``pool``
    layer and ``head`` maps it to the output, the two names every spec's
    ``layer_names`` lists."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.forward_features(x))

    def forward_with_intermediates(self, x: torch.Tensor, layers=None):
        """``(output, {"pool": features, "head": output})``. ``layers`` (the
        names the caller will read) is accepted for the zoo's common
        signature; the head is cheap, so both are always computed."""
        pool = self.forward_features(x)
        out = self.head(pool)
        return out, {"pool": pool, "head": out}


# populate the registry
from mmlspark_tpu_torch.models.zoo import resnet as _resnet  # noqa: E402,F401
from mmlspark_tpu_torch.models.zoo import mlp as _mlp  # noqa: E402,F401
from mmlspark_tpu_torch.models.zoo import vit as _vit  # noqa: E402,F401
from mmlspark_tpu_torch.models.zoo import transformer as _transformer  # noqa: E402,F401
from mmlspark_tpu_torch.models.zoo import moe as _moe  # noqa: E402,F401
