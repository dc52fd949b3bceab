"""Deterministic fault injection: named sites and an Nth-hit trigger plan.

The port's minimal copy of ``mmlspark_tpu/reliability/faults.py``. Code
marks its crash-relevant points with :func:`fault_site` (the trainer's
``trainer.train_step``); with no plan installed that is a single global
read. A test installs a :class:`FaultPlan` to raise on the exact Nth hit
of a site::

    with FaultPlan(FaultSpec("trainer.train_step", on_hit=3)):
        run_training()          # the 3rd step raises InjectedFault

Only the ``raise`` action is ported; the truncate and delay actions come
with the readers and downloaders that use them.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

_LOCK = threading.Lock()
_ACTIVE: Optional["FaultPlan"] = None


class InjectedFault(RuntimeError):
    """What a triggered fault raises."""


def fault_site(name: str, payload: Any = None) -> Any:
    """A named fault-injection point: raises per the active plan, and
    otherwise returns ``payload`` unchanged (the reference's truncate
    action, which transforms it, is not ported)."""
    plan = _ACTIVE
    if plan is not None:
        plan.hit(name)
    return payload


@dataclass
class FaultSpec:
    """Raise on hits ``on_hit`` through ``on_hit + times - 1`` (1-based)
    of ``site``."""

    site: str
    on_hit: int = 1
    times: int = 1


class FaultPlan:
    """Process-wide fault schedule (context manager); plans do not nest.
    ``triggered`` records each fired ``(site, hit)``."""

    def __init__(self, *specs: FaultSpec):
        self.specs: List[FaultSpec] = list(specs)
        self.hits: Dict[str, int] = {}
        self.triggered: List[Tuple[str, int]] = []

    def __enter__(self) -> "FaultPlan":
        global _ACTIVE
        with _LOCK:
            if _ACTIVE is not None:
                raise RuntimeError(
                    "a FaultPlan is already active; plans do not nest")
            _ACTIVE = self
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        global _ACTIVE
        with _LOCK:
            _ACTIVE = None
        return False

    def hit(self, name: str) -> None:
        with _LOCK:
            n = self.hits.get(name, 0) + 1
            self.hits[name] = n
        for spec in self.specs:
            if spec.site == name and spec.on_hit <= n < spec.on_hit + spec.times:
                self.triggered.append((name, n))
                raise InjectedFault(f"injected fault at {name} (hit {n})")
