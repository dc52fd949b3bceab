"""Heartbeat registry: long-running loops beat on every unit of progress.

The port's minimal copy of ``mmlspark_tpu/reliability/watchdog.py``: the
trainer and the prefetcher :func:`register` a :class:`Heartbeat`, call
``beat()`` per step or batch, and ``close()`` it when they finish, so a
finished loop can never look stalled. A beat is one attribute write.
The monitor thread that flags silent heartbeats and dumps every thread's
stack is not ported yet (ROADMAP, observability and reliability).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List

_LOCK = threading.Lock()
_REGISTRY: Dict[int, "Heartbeat"] = {}


class Heartbeat:
    """One monitored loop's liveness handle. ``beat()`` after ``close()``
    is a harmless no-op, so shutdown order never matters."""

    __slots__ = ("name", "last", "beats")

    def __init__(self, name: str):
        self.name = name
        self.last = time.monotonic()
        self.beats = 0

    def beat(self) -> None:
        self.last = time.monotonic()
        self.beats += 1

    def close(self) -> None:
        with _LOCK:
            _REGISTRY.pop(id(self), None)


def register(name: str) -> Heartbeat:
    """Register a heartbeat for one loop instance."""
    hb = Heartbeat(name)
    with _LOCK:
        _REGISTRY[id(hb)] = hb
    return hb


def registered() -> List[Heartbeat]:
    with _LOCK:
        return list(_REGISTRY.values())
