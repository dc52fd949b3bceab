"""Deterministic fault injection: named sites and an Nth-hit trigger plan.

The port's copy of ``mmlspark_tpu/reliability/faults.py``. Code marks its
crash-relevant points with :func:`fault_site`; with no plan installed
that is a single global read. A test installs a :class:`FaultPlan` that
triggers an exact action on the exact Nth hit of a site::

    with FaultPlan(FaultSpec("checkpoint.save", on_hit=3)):
        run_training()          # the 3rd checkpoint save raises InjectedFault

Instrumented sites of the port:

- ``checkpoint.save``     — before a checkpoint's host snapshot
- ``checkpoint.save.commit`` — after the snapshot, before the write
- ``checkpoint.restore``  — before a checkpoint loads
- ``readers.read``        — carries each binary file/zip-entry payload
- ``data.list``           — before the input pipeline lists/shards files
- ``data.shuffle``        — before each shuffle window permutes
- ``data.decode``         — before each record enters the decode pool
- ``trainer.train_step``  — before each train step
- ``serve.*`` and ``generate.*`` — the server's and the generate lane's
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Type, Union

from mmlspark_tpu_torch.utils.logging import get_logger

_LOG = get_logger("reliability.faults")
_LOCK = threading.Lock()
_ACTIVE: Optional["FaultPlan"] = None


class InjectedFault(RuntimeError):
    """The default exception a triggered ``raise`` fault throws."""


def fault_site(name: str, payload: Any = None) -> Any:
    """Mark a named fault-injection point.

    Returns ``payload`` unchanged (possibly transformed by a triggered
    ``truncate`` fault) or raises per the active :class:`FaultPlan`. A
    no-op returning ``payload`` when no plan is installed.
    """
    plan = _ACTIVE
    if plan is None:
        return payload
    return plan.hit(name, payload)


@dataclass
class FaultSpec:
    """One trigger rule: fire ``action`` on hits ``on_hit`` through
    ``on_hit + times - 1`` (1-based) of ``site``.

    Actions: ``"raise"`` throws ``exc`` (an instance, an exception class,
    or None for :class:`InjectedFault`); ``"truncate"`` keeps the first
    ``fraction`` of the site's payload (a cut connection or partial
    write); ``"delay"`` sleeps ``delay`` seconds (a stalled link, for
    timeout paths).
    """

    site: str
    on_hit: int = 1
    times: int = 1
    action: str = "raise"
    exc: Union[BaseException, Type[BaseException], None] = None
    fraction: float = 0.5
    delay: float = 0.0

    def triggers(self, n: int) -> bool:
        return self.on_hit <= n < self.on_hit + self.times

    def make_exc(self, site: str, n: int) -> BaseException:
        if self.exc is None:
            return InjectedFault(f"injected fault at {site} (hit {n})")
        if isinstance(self.exc, type):
            return self.exc(f"injected fault at {site} (hit {n})")
        return self.exc


class FaultPlan:
    """Process-wide deterministic fault schedule (context manager).

    Counts hits per site under a lock and applies every matching
    :class:`FaultSpec` in order. Plans do not nest. ``triggered`` records
    each fired ``(site, hit, action)``; ``sleep`` is injectable so delay
    faults don't slow the tests.
    """

    def __init__(self, *specs: FaultSpec,
                 sleep: Callable[[float], None] = time.sleep):
        self.specs: List[FaultSpec] = list(specs)
        self.hits: Dict[str, int] = {}
        self.triggered: List[Tuple[str, int, str]] = []
        self._sleep = sleep

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

    def hit(self, name: str, payload: Any = None) -> Any:
        with _LOCK:
            n = self.hits.get(name, 0) + 1
            self.hits[name] = n
        for spec in self.specs:
            if spec.site != name or not spec.triggers(n):
                continue
            self.triggered.append((name, n, spec.action))
            _LOG.info("fault %r fired at %s (hit %d)", spec.action, name, n)
            # a triggered fault is rare by construction: safe to count/emit
            from mmlspark_tpu_torch.observability import (
                events, metrics as obsmetrics,
            )
            obsmetrics.counter("reliability.fault_hits").inc()
            if events.events_enabled():
                events.emit("event", "fault.hit", site=name, hit=n,
                            action=spec.action)
            if spec.action == "delay":
                self._sleep(spec.delay)
            elif spec.action == "truncate":
                if payload is None:
                    raise InjectedFault(
                        f"truncate fault at payload-less site {name}")
                payload = payload[:int(len(payload) * spec.fraction)]
            elif spec.action == "raise":
                raise spec.make_exc(name, n)
            else:
                raise ValueError(f"unknown fault action {spec.action!r}")
        return payload
