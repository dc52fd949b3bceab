"""Optimizers and learning-rate schedules: the optax twins the port needs.

The JAX package builds its optimizers from optax (``train/deep.py``,
``bench.py``); this module is the port's home for their counterparts on
``torch.optim``, with optax's update rules:

- :func:`sgd` ``(lr, momentum=0.9)``: optax keeps ``t = g + m * t`` and
  steps ``p -= lr * t``, which is ``torch.optim.SGD`` with ``dampening=0``
  and ``nesterov=False``;
- :func:`adam`: eps outside the square root (optax ``eps_root=0``), as
  torch does;
- :func:`adamw`: decoupled decay of every parameter (optax applies no mask
  by default), as ``torch.optim.AdamW`` does; optax's default decay 1e-4
  is kept, not torch's 1e-2;
- :func:`lamb` and :func:`adafactor`: torch has no LAMB, and
  ``torch.optim.Adafactor`` follows other rules (no parameter scale,
  another decay and eps), so :class:`Lamb` and :class:`Adafactor` are
  written here from optax 0.2.6's chains, their state in float32.

On a mesh (``parallel/trainer.py``) each rank steps the shards it holds.
adam, adamw and sgd are elementwise; Lamb's trust-ratio norms and
Adafactor's factored moments and RMS are reductions over a whole
parameter, so over a split parameter their sums run over the ranks that
hold its shards (:func:`_sum_over`), and :func:`state_sharding` says how
each state tensor is split, for checkpoints.

An :class:`Optimizer` is a recipe, like an optax ``GradientTransformation``:
:meth:`Optimizer.init` builds the torch optimizer over the parameters it is
given. A learning rate may be a float or a schedule, a plain function of
the update count. optax evaluates a schedule at the count BEFORE the update
(the first update uses ``schedule(0)``); :meth:`OptimizerState.step` sets
the rate from its host-side count first, then steps, then counts. The
count is a host int, so stepping reads nothing from the device.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from mmlspark_tpu_torch.parallel import collectives

Schedule = Callable[[int], float]
LearningRate = Union[float, Schedule]


class OptimizerState:
    """A built optimizer: the torch optimizer, its schedule and the number
    of updates applied."""

    def __init__(self, opt: torch.optim.Optimizer, lr: LearningRate):
        self.torch = opt
        self.lr = lr
        self.count = 0

    def zero_grad(self) -> None:
        self.torch.zero_grad(set_to_none=True)

    def step(self) -> None:
        if callable(self.lr):
            rate = float(self.lr(self.count))
            for group in self.torch.param_groups:
                group["lr"] = rate
        self.torch.step()
        self.count += 1


class Optimizer:
    """A recipe for a torch optimizer (``cls`` and its keyword arguments)
    with a learning rate or schedule."""

    def __init__(self, cls, lr: LearningRate, **kwargs):
        self.cls = cls
        self.lr = lr
        self.kwargs = kwargs

    def init(self, params: Iterable[torch.nn.Parameter]) -> OptimizerState:
        first = float(self.lr(0)) if callable(self.lr) else float(self.lr)
        return OptimizerState(self.cls(list(params), lr=first, **self.kwargs),
                              self.lr)


def sgd(lr: LearningRate, momentum: float = 0.0) -> Optimizer:
    """optax.sgd: momentum without dampening or Nesterov."""
    return Optimizer(torch.optim.SGD, lr, momentum=momentum, dampening=0.0,
                     nesterov=False)


def adam(lr: LearningRate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    """optax.adam (eps_root 0)."""
    return Optimizer(torch.optim.Adam, lr, betas=(b1, b2), eps=eps)


def adamw(lr: LearningRate, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> Optimizer:
    """optax.adamw: decoupled decay of every parameter."""
    return Optimizer(torch.optim.AdamW, lr, betas=(b1, b2), eps=eps,
                     weight_decay=weight_decay)


def _sharding(p):
    """The mesh placement the trainer gave ``p``, or None."""
    sh = getattr(p, "_mesh_sharding", None)
    return sh if sh is not None and sh.sharded else None


def _dim_group(p, dim: int):
    """The group over which ``p``'s dim ``dim`` is split, or None."""
    sh = _sharding(p)
    if sh is None or sh.spec[dim] is None:
        return None
    from mmlspark_tpu_torch.parallel.sharding import _axes
    return p._mesh_layout.group(*_axes(sh.spec[dim]))


def _sum_over(x: torch.Tensor, group) -> torch.Tensor:
    return collectives.all_reduce(x, group) if group is not None else x


def _norm(x: torch.Tensor, p) -> torch.Tensor:
    """The L2 norm of the whole parameter ``x`` is (a shard) of."""
    if _sharding(p) is None:
        return torch.linalg.vector_norm(x)
    return torch.sqrt(_sum_over((x * x).sum(), p._mesh_group))


def _mean(x: torch.Tensor, p) -> torch.Tensor:
    """The mean over the whole parameter ``x`` is (a shard) of."""
    sh = _sharding(p)
    if sh is None:
        return torch.mean(x)
    return _sum_over(x.sum(), p._mesh_group) / math.prod(sh.shape)


def _mean_dim(x: torch.Tensor, dim: int, p, pdim: int,
              keepdim: bool = False) -> torch.Tensor:
    """The mean of ``x`` over its ``dim``, which is ``p``'s dim
    ``pdim`` (split or not)."""
    group = _dim_group(p, pdim)
    if group is None:
        return x.mean(dim=dim, keepdim=keepdim)
    return _sum_over(x.sum(dim=dim, keepdim=keepdim), group) \
        / _sharding(p).shape[pdim]


class Lamb(torch.optim.Optimizer):
    """optax.lamb: ``scale_by_adam(b1=0.9, b2=0.999, eps=1e-6,
    eps_root=0)``, then ``add_decayed_weights(weight_decay)`` on every
    parameter, then ``scale_by_trust_ratio()`` per parameter, then ``-lr``.

    The trust ratio is ``||p|| / ||u||``, and 1 where either norm is 0.
    The bias corrections ``1 - b**t`` are computed in float32, as optax
    does; the step count is a host int, so a step reads nothing from the
    device."""

    B1, B2, EPS = 0.9, 0.999, 1e-6

    def __init__(self, params, lr: float, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        self.count += 1
        t = np.float32(self.count)
        c1 = float(np.float32(1) - np.float32(self.B1) ** t)
        c2 = float(np.float32(1) - np.float32(self.B2) ** t)
        for group in self.param_groups:
            wd, lr = group["weight_decay"], group["lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad.float()
                state = self.state[p]
                if not state:
                    state["mu"] = torch.zeros_like(g)
                    state["nu"] = torch.zeros_like(g)
                mu, nu = state["mu"], state["nu"]
                mu.mul_(self.B1).add_(g, alpha=1.0 - self.B1)
                nu.mul_(self.B2).add_(g * g, alpha=1.0 - self.B2)
                u = (mu / c1) / ((nu / c2).sqrt() + self.EPS)
                w = p.float()
                if wd:
                    u = u + wd * w
                p_norm, u_norm = _norm(w, p), _norm(u, p)
                ratio = torch.where((p_norm == 0) | (u_norm == 0),
                                    torch.ones_like(p_norm), p_norm / u_norm)
                p.sub_((u * ratio * lr).to(p.dtype))


# optax.adafactor's defaults: factor a parameter's second moment when its
# two largest axes are both at least this long
_MIN_DIM_TO_FACTOR = 128


def _factored_dims(shape: Sequence[int]) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: the (second largest, largest) axes of a
    parameter of rank >= 2 whose second largest axis is at least
    ``_MIN_DIM_TO_FACTOR``, else None (the second moment is kept whole)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < _MIN_DIM_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(torch.optim.Optimizer):
    """optax.adafactor with its defaults: ``scale_by_factored_rms``, then
    ``clip_by_block_rms(1.0)``, then ``lr``, then
    ``scale_by_param_block_rms(1e-3)``, then ``-1``; no momentum, no
    weight decay.

    - A parameter whose two largest axes are both at least 128 keeps a row
      and a column mean of ``g**2 + 1e-30`` (the second moment factored
      over those axes); any other keeps ``g**2 + 1e-30`` whole.
    - The decay at the update of count ``t`` (from 0) is ``1 - (t + 1) **
      -0.8``, in float32.
    - The update's RMS is clipped to 1, and the update is scaled by
      ``max(RMS(p), 1e-3)``.

    The factored update ``g * sqrt(mean(R)) / sqrt(R_i * C_j)`` is the same
    for a transposed layout (torch's ``(out, in)`` against flax's ``(in,
    out)``), so the rule holds on the port's parameters as optax's holds
    on flax's."""

    DECAY_RATE, EPS, CLIP, MIN_SCALE = 0.8, 1e-30, 1.0, 1e-3

    def __init__(self, params, lr: float):
        super().__init__(params, dict(lr=lr))
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        t = np.float32(self.count + 1)
        decay = float(np.float32(1) - t ** np.float32(-self.DECAY_RATE))
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    p.sub_(self._update(p, group["lr"], decay).to(p.dtype))
        self.count += 1

    def _update(self, p, lr: float, decay: float) -> torch.Tensor:
        g = p.grad.float()
        state = self.state[p]
        sh = _sharding(p)
        dims = _factored_dims(sh.shape if sh is not None else tuple(p.shape))
        g2 = g * g + self.EPS
        if dims is not None:
            d1, d0 = dims
            if not state:
                state["v_row"] = torch.zeros_like(g.mean(dim=d0))
                state["v_col"] = torch.zeros_like(g.mean(dim=d1))
            v_row, v_col = state["v_row"], state["v_col"]
            v_row.mul_(decay).add_(_mean_dim(g2, d0, p, d0),
                                   alpha=1.0 - decay)
            v_col.mul_(decay).add_(_mean_dim(g2, d1, p, d1),
                                   alpha=1.0 - decay)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = _mean_dim(v_row, reduced_d1, p, d1, keepdim=True)
            row_factor = (v_row / row_col_mean).rsqrt()
            u = g * row_factor.unsqueeze(d0) * v_col.rsqrt().unsqueeze(d1)
        else:
            if not state:
                state["v"] = torch.zeros_like(g)
            v = state["v"]
            v.mul_(decay).add_(g2, alpha=1.0 - decay)
            u = g * v.rsqrt()
        u = u / torch.clamp(torch.sqrt(_mean(u * u, p)) / self.CLIP,
                            min=1.0)
        w = p.float()
        scale = torch.clamp(torch.sqrt(_mean(w * w, p)), min=self.MIN_SCALE)
        return u * lr * scale


def state_sharding(p, key: str, shape, whole: bool = False):
    """How the optimizer state ``key`` of parameter ``p`` is split on the
    mesh (a ``ParamSharding``), or None when it is replicated: a tensor
    shaped like the parameter is split like it, Adafactor's factored
    moments like the parameter without the dim they average over.
    ``shape`` is the state's local shape, or its whole shape when
    ``whole``."""
    sh = _sharding(p)
    if sh is None:
        return None
    from mmlspark_tpu_torch.parallel.sharding import without_dim
    if key in ("v_row", "v_col"):
        d1, d0 = _factored_dims(sh.shape)
        return without_dim(sh, d0 if key == "v_row" else d1)
    like = sh.shape if whole else tuple(p.shape)
    return sh if tuple(shape) == like else None


def lamb(lr: LearningRate, weight_decay: float = 0.0) -> Optimizer:
    """optax.lamb (:class:`Lamb`)."""
    return Optimizer(Lamb, lr, weight_decay=weight_decay)


def adafactor(lr: LearningRate) -> Optimizer:
    """optax.adafactor with its defaults (:class:`Adafactor`)."""
    return Optimizer(Adafactor, lr)


# -- schedules: optax's formulas, as plain functions of the count ----------

def constant_schedule(value: float) -> Schedule:
    return lambda count: value


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """optax.linear_schedule: from ``init_value`` to ``end_value`` over
    ``transition_steps`` updates, then held; held at ``init_value`` when
    ``transition_steps <= 0``."""
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(count: int) -> float:
        frac = 1.0 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int) -> Schedule:
    """optax.cosine_decay_schedule with alpha 0 and exponent 1."""
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got "
                         f"{decay_steps}")

    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        return init_value * 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
    return schedule


def join_schedules(schedules: Sequence[Schedule],
                   boundaries: Sequence[int]) -> Schedule:
    """optax.join_schedules: schedule ``i + 1`` takes over at
    ``boundaries[i]``, counting from it."""
    def schedule(count: int) -> float:
        value = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                value = sched(count - boundary)
        return value
    return schedule


def warmup_schedule(kind: str, lr: float, warmup_steps: int,
                    total_steps: int) -> LearningRate:
    """The schedules of ``DeepClassifier``'s ``lrSchedule`` param, each with
    ``warmup_steps`` of linear warmup from 0, over a fit of ``total_steps``
    updates: ``"constant"``, ``"cosine"`` (to 0) or ``"linear"`` (to 0).
    A constant rate without warmup is the float itself."""
    warm = int(warmup_steps)
    total = max(int(total_steps), warm + 1)
    if kind == "cosine":
        return join_schedules(
            [linear_schedule(0.0 if warm else lr, lr, warm),
             cosine_decay_schedule(lr, total - warm)], [warm])
    if kind == "linear":
        return join_schedules(
            [linear_schedule(0.0, lr, max(warm, 1)),
             linear_schedule(lr, 0.0, total - warm)], [warm])
    if kind != "constant":
        raise ValueError(f"unknown schedule {kind!r}")
    if warm:
        return join_schedules([linear_schedule(0.0, lr, warm),
                               constant_schedule(lr)], [warm])
    return lr
