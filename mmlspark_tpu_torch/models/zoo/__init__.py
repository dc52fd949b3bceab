"""Model zoo registry: architecture name -> constructor.

The port's counterpart of ``mmlspark_tpu/models/zoo/__init__.py``: every
architecture registers under the same stable name with the same spec dict
(``module``, ``input_shape``, ``feature_layer``, ``feature_dim``,
``layer_names``), so stages and saved state name models the same way in
both packages. ``module`` is an ``nn.Module`` whose parameters are
allocated but not initialized; :func:`init_state` fills a state dict from a
seed. Registered so far: the ResNets and the tabular MLP.
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


def init_state(module: torch.nn.Module, seed: int = 0) -> Dict[str, np.ndarray]:
    """A fresh state dict for ``module`` (numpy, the port's state layout),
    drawn from a ``torch.Generator`` seeded with ``seed``, with flax's
    default initializers: conv and dense weights lecun-normal (truncated
    at two standard deviations, ``fan_in`` = every axis but the output
    one), norm weights one, biases zero. The draws differ from
    ``jax.random``'s for the same seed; tests that need both packages to
    score the same weights pass the JAX parameters through
    :func:`mmlspark_tpu_torch.models.convert.from_jax_params`."""
    gen = torch.Generator().manual_seed(int(seed))
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    state = {}
    for name, p in module.named_parameters():
        if name.endswith("weight") and p.ndim >= 2:
            fan_in = math.prod(p.shape[1:])
            # stddev of a unit normal truncated to [-2, 2] is 0.8796...
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            u = lo + (1.0 - 2.0 * lo) * torch.rand(p.shape, generator=gen)
            z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
            value = z.clamp(-2.0, 2.0) * std
        elif name.endswith("weight"):
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

    def forward_with_intermediates(self, x: torch.Tensor):
        """``(output, {"pool": features, "head": output})``."""
        pool = self.forward_features(x)
        out = self.head(pool)
        return out, {"pool": pool, "head": out}


# populate the registry
from mmlspark_tpu_torch.models.zoo import resnet as _resnet  # noqa: E402,F401
from mmlspark_tpu_torch.models.zoo import mlp as _mlp  # noqa: E402,F401
