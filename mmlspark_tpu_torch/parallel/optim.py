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
  is kept, not torch's 1e-2.

An :class:`Optimizer` is a recipe, like an optax ``GradientTransformation``:
:meth:`Optimizer.init` builds the torch optimizer over the parameters it is
given. A learning rate may be a float or a schedule, a plain function of
the update count. optax evaluates a schedule at the count BEFORE the update
(the first update uses ``schedule(0)``); :meth:`OptimizerState.step` sets
the rate from its host-side count first, then steps, then counts. The
count is a host int, so stepping reads nothing from the device.

``lamb`` and ``adafactor`` are not ported yet (ROADMAP).
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, Sequence, Union

import torch

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


def lamb(lr: LearningRate, weight_decay: float = 0.0) -> Optimizer:
    raise NotImplementedError(
        "lamb is not ported yet (ROADMAP, slice 2 left-outs); use adamw, "
        "adam or sgd")


def adafactor(lr: LearningRate) -> Optimizer:
    raise NotImplementedError(
        "adafactor is not ported yet (ROADMAP, slice 2 left-outs); use "
        "adamw, adam or sgd")


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
