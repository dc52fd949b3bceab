"""Preemption signal: SIGTERM/SIGINT -> graceful checkpoint-and-drain.

The port's copy of ``mmlspark_tpu/reliability/preemption.py``, unchanged
but for the package name. Preemptible capacity gives ~30s of notice as a
SIGTERM. The default
Python behavior (KeyboardInterrupt mid-`urlopen`, or instant death) turns
that notice into a corrupt half-written step; this module turns it into a
process-wide flag that the long-running loops POLL at their own safe
points:

- :class:`~mmlspark_tpu_torch.reliability.resilient.ResilientTrainLoop`
  checks :func:`preempted` every step and, on preemption, writes a final
  checkpoint + data-state sidecar and returns cleanly — the next run
  resumes bit-identically;
- ``serve.Server`` / ``mmlspark-tpu-torch serve`` drain: stop admission (503 +
  ``Retry-After``), finish in-flight batches, then close.

Design rules:

- The handler does NOTHING but set an event and emit telemetry — no
  checkpointing, no locks, no allocation-heavy work in signal context.
- Handlers install only on the main thread (CPython requirement) and are
  a no-op with a warning elsewhere, so library code may call
  :func:`install_handlers` unconditionally.
- :func:`request_preemption` flips the same flag programmatically — the
  watchdog's checkpoint-and-abort action and tests use it, so every
  consumer has exactly one condition to poll.

This module is the ONLY place ``signal.signal(`` is called: scattering
handlers across modules makes the last installer win silently, which is
precisely the bug class this central flag exists to kill.
"""
from __future__ import annotations

import signal
import threading
from typing import Dict, Optional

from mmlspark_tpu_torch.utils.logging import get_logger

_LOG = get_logger("reliability.preemption")


class PreemptionSignal:
    """Process-wide latch: set once by a signal/request, polled by loops.

    Thread-safe; ``reason`` records what tripped it (``"SIGTERM"``,
    ``"SIGINT"``, or a caller-supplied string) for the event log and the
    final run report.
    """

    def __init__(self):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._reason: Optional[str] = None

    def set(self, reason: str) -> None:
        with self._lock:
            if self._reason is None:
                self._reason = reason
        self._event.set()

    def is_set(self) -> bool:
        return self._event.is_set()

    @property
    def reason(self) -> Optional[str]:
        with self._lock:
            return self._reason

    def clear(self) -> None:
        with self._lock:
            self._reason = None
        self._event.clear()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)


_SIGNAL = PreemptionSignal()
_installed: Dict[int, object] = {}   # signum -> previous handler


def get_signal() -> PreemptionSignal:
    """The process-wide preemption latch (one per process, like the
    active fault plan in :mod:`~mmlspark_tpu_torch.reliability.faults`)."""
    return _SIGNAL


def preempted() -> bool:
    """Cheap poll for loop bodies: has a preemption been requested?"""
    return _SIGNAL.is_set()


def preemption_reason() -> Optional[str]:
    return _SIGNAL.reason


def request_preemption(reason: str = "requested") -> None:
    """Flip the latch programmatically (watchdog abort action, tests,
    orchestrators that learn of preemption out-of-band)."""
    first = not _SIGNAL.is_set()
    _SIGNAL.set(reason)
    if first:
        _LOG.warning("preemption requested (%s): draining to a clean stop",
                     reason)
        _emit(reason)


def reset() -> None:
    """Clear the latch (tests, or a supervisor re-arming after a drain)."""
    _SIGNAL.clear()


def _emit(reason: str) -> None:
    from mmlspark_tpu_torch.observability import events, metrics
    metrics.counter("reliability.preemptions").inc()
    if events.events_enabled():
        events.emit("event", "preemption.signal", reason=reason)


def _handler(signum, frame) -> None:
    # Signal context: set the flag, nothing else. emit() appends one
    # JSONL line which is safe enough here and invaluable forensically.
    name = signal.Signals(signum).name
    first = not _SIGNAL.is_set()
    _SIGNAL.set(name)
    if first:
        _LOG.warning("received %s: draining to a clean stop", name)
        _emit(name)


def install_handlers(signums=(signal.SIGTERM, signal.SIGINT)) -> bool:
    """Install the preemption handler for ``signums`` on the main thread.

    Returns True if installed; False (with a warning) when called off the
    main thread, where CPython forbids ``signal.signal``. Idempotent —
    re-installing over ourselves does not clobber the saved previous
    handlers.
    """
    if threading.current_thread() is not threading.main_thread():
        _LOG.warning("install_handlers() called off the main thread; "
                     "preemption handlers NOT installed")
        return False
    for signum in signums:
        prev = signal.signal(signum, _handler)
        if signum not in _installed:
            _installed[signum] = prev
    return True


def uninstall_handlers() -> None:
    """Restore the pre-install handlers (tests / embedding hosts)."""
    if threading.current_thread() is not threading.main_thread():
        return
    while _installed:
        signum, prev = _installed.popitem()
        signal.signal(signum, prev)
