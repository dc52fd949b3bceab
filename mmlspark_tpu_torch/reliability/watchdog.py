"""Watchdog: heartbeat registry + stall detection with all-thread dumps.

The port's copy of ``mmlspark_tpu/reliability/watchdog.py``. Retries and
crash-resume react to failures that announce themselves; a hang does not
— a wedged device program, a deadlocked queue or a stuck fetch just burns
the deadline silently. Two pieces close that gap:

- **Heartbeats**: long-running loops register a :class:`Heartbeat` handle
  and call ``beat()`` on every unit of progress (a train step, a decoded
  record, a prefetched batch). A beat is ONE attribute write, always on.
  The handle deregisters on ``close()`` so a finished loop can never look
  stalled.
- **The monitor**: a :class:`Watchdog` thread wakes every ``poll_s`` and
  flags any registered heartbeat whose last beat is older than its stall
  timeout (``reliability.stall_timeout_s`` by default, per-handle
  override). A stall dumps EVERY thread's stack to the log and the event
  log (``watchdog.stall`` + the ``reliability.watchdog_stalls`` counter),
  then invokes the configured action:

  - ``"warn"`` (default): log + telemetry only;
  - ``"abort"``: additionally request a graceful preemption
    (:func:`mmlspark_tpu_torch.reliability.preemption.request_preemption`),
    so ``ResilientTrainLoop`` checkpoints and exits cleanly and
    ``serve.Server`` drains — checkpoint-and-abort, not kill -9;
  - any callable ``action(stall: Stall)`` for custom escalation.

A stall fires ONCE per heartbeat until that heartbeat beats again. The
module clock is injectable (:func:`set_clock`) and the check loop is
callable directly (:meth:`Watchdog.check`), so tests drive detection with
zero sleeps and zero real threads. A stall also dumps the flight
recorder's ring (``observability/flightrec.py``) at once: a stall often
comes before a kill from outside, after which nothing is left to dump,
and the ring is on even where no events path was set.
"""
from __future__ import annotations

import sys
import threading
import traceback
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Union

from mmlspark_tpu_torch.utils import config as mmlconfig
from mmlspark_tpu_torch.utils.logging import get_logger

_LOG = get_logger("reliability.watchdog")

_LOCK = threading.Lock()
_REGISTRY: Dict[int, "Heartbeat"] = {}
_clock: Callable[[], float] = time.monotonic


def set_clock(fn: Optional[Callable[[], float]]) -> None:
    """Inject a fake monotonic clock (tests); ``None`` restores the real
    one. Heartbeat timestamps and watchdog checks share this clock, so an
    injected test clock advances both consistently."""
    global _clock
    _clock = fn if fn is not None else time.monotonic


class Heartbeat:
    """One monitored loop's liveness handle.

    ``beat()`` is a single attribute write (no lock: CPython attribute
    stores are atomic, and the monitor only ever reads a slightly-stale
    value — off by at most one beat, which stall detection tolerates by
    construction). ``close()`` deregisters; a closed handle's ``beat()``
    is a harmless no-op so shutdown ordering never matters.
    """

    __slots__ = ("name", "timeout_s", "last", "beats", "_stalled")

    def __init__(self, name: str, timeout_s: Optional[float] = None):
        self.name = name
        self.timeout_s = timeout_s          # None = config default at check
        self.last = _clock()
        self.beats = 0
        self._stalled = False               # re-arm latch (one event/hang)

    def beat(self) -> None:
        self.last = _clock()
        self.beats += 1
        self._stalled = False

    def close(self) -> None:
        with _LOCK:
            _REGISTRY.pop(id(self), None)

    def __enter__(self) -> "Heartbeat":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False


def register(name: str, timeout_s: Optional[float] = None) -> Heartbeat:
    """Register a heartbeat for one loop instance. Always cheap and always
    on — whether anything WATCHES is the :class:`Watchdog` owner's call,
    so instrumented code never needs to know if a monitor exists."""
    hb = Heartbeat(name, timeout_s)
    with _LOCK:
        _REGISTRY[id(hb)] = hb
    return hb


def registered() -> List[Heartbeat]:
    with _LOCK:
        return list(_REGISTRY.values())


@dataclass
class Stall:
    """One detected stall: the silent heartbeat plus the evidence."""

    name: str
    stalled_s: float
    timeout_s: float
    beats: int
    stacks: str


def dump_all_stacks() -> str:
    """Every live thread's current stack, formatted — the post-mortem
    snapshot a hung process can still produce (a crashed one cannot)."""
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    out: List[str] = []
    for ident, frame in frames.items():
        out.append(f"--- thread {names.get(ident, '?')} ({ident}) ---")
        out.extend(l.rstrip("\n")
                   for l in traceback.format_stack(frame))
    return "\n".join(out)


class Watchdog:
    """Monitor thread over the process heartbeat registry.

    ``action`` is ``"warn"``, ``"abort"`` (graceful preemption via the
    :mod:`~mmlspark_tpu_torch.reliability.preemption` signal), or a callable
    taking the :class:`Stall`. ``stall_timeout_s`` defaults from
    ``reliability.stall_timeout_s`` (0 disables detection entirely);
    ``poll_s`` from ``reliability.watchdog_poll_s``. ``start=False``
    leaves the thread unstarted — tests call :meth:`check` directly
    under an injected clock.
    """

    def __init__(self, stall_timeout_s: Optional[float] = None,
                 action: Union[str, Callable[[Stall], None]] = "warn",
                 poll_s: Optional[float] = None, start: bool = True):
        self.stall_timeout_s = float(
            stall_timeout_s if stall_timeout_s is not None
            else mmlconfig.get("reliability.stall_timeout_s"))
        self.poll_s = float(poll_s if poll_s is not None
                            else mmlconfig.get("reliability.watchdog_poll_s"))
        if isinstance(action, str) and action not in ("warn", "abort"):
            raise ValueError(
                f"action must be 'warn', 'abort', or callable, got {action!r}")
        self.action = action
        self.stalls: List[Stall] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="mmlspark-tpu-torch-watchdog", daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop the monitor thread. Idempotent."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def __enter__(self) -> "Watchdog":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            self.check()

    # -- detection ---------------------------------------------------------
    def check(self, now: Optional[float] = None) -> List[Stall]:
        """One detection pass; returns the stalls flagged THIS pass (each
        heartbeat fires at most once until it beats again)."""
        if self.stall_timeout_s <= 0:
            return []
        if now is None:
            now = _clock()
        fired: List[Stall] = []
        for hb in registered():
            timeout = (hb.timeout_s if hb.timeout_s is not None
                       else self.stall_timeout_s)
            if timeout <= 0 or hb._stalled:
                continue
            stalled_s = now - hb.last
            if stalled_s <= timeout:
                continue
            hb._stalled = True
            stall = Stall(name=hb.name, stalled_s=stalled_s,
                          timeout_s=timeout, beats=hb.beats,
                          stacks=dump_all_stacks())
            fired.append(stall)
            self.stalls.append(stall)
            self._report(stall)
        return fired

    def _report(self, stall: Stall) -> None:
        _LOG.error(
            "watchdog: %r silent for %.1fs (timeout %.1fs, %d beats); "
            "all-thread stacks:\n%s", stall.name, stall.stalled_s,
            stall.timeout_s, stall.beats, stall.stacks)
        # a stall is rare and already catastrophic-adjacent: count and
        # emit unconditionally-cheap telemetry, never swallow its cost
        from mmlspark_tpu_torch.observability import (events, flightrec,
                                                      metrics)
        metrics.counter("reliability.watchdog_stalls").inc()
        if events.recording_enabled():
            events.emit("event", "watchdog.stall", heartbeat=stall.name,
                        stalled_s=round(stall.stalled_s, 3),
                        timeout_s=stall.timeout_s, beats=stall.beats,
                        stacks=stall.stacks)
        dumped = flightrec.dump(reason=f"watchdog.stall.{stall.name}")
        if dumped:
            _LOG.error("watchdog: flight recorder dumped to %s", dumped)
        try:
            if callable(self.action):
                self.action(stall)
            elif self.action == "abort":
                from mmlspark_tpu_torch.reliability import preemption
                preemption.request_preemption(
                    f"watchdog stall: {stall.name} silent "
                    f"{stall.stalled_s:.1f}s")
        except Exception as e:
            # the monitor must survive a broken action — it may be the
            # only thread still reporting anything
            _LOG.error("watchdog action failed (%s: %s)",
                       type(e).__name__, e)
