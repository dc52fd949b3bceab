"""Circuit breakers: stop hammering a dependency that is actively failing.

The port's copy of ``mmlspark_tpu/reliability/breaker.py``, unchanged but
for its imports.

Retries (``retry.py``) make ONE call robust; they also make a DOWN
dependency worse — every request burns its full backoff schedule against
an endpoint that cannot answer, and under serving load those stacked
deadlines become the outage. The circuit breaker (Clipper/Hystrix-style)
sits ABOVE the retry layer and converts repeated failure into fast
rejection:

- **closed** (healthy): calls pass through; consecutive failures are
  counted, any success resets the count.
- **open** (tripped): after ``failure_threshold`` consecutive failures,
  calls fail immediately with :class:`CircuitOpen` — no network, no
  backoff — for ``reset_timeout_s``.
- **half-open** (probing): after the cooldown, exactly ONE caller is let
  through. Success closes the breaker; failure re-opens it and restarts
  the cooldown.

``CircuitOpen.retryable`` is True, so a breaker wrapped INSIDE a
``RetryPolicy`` composes correctly: the retry layer backs off (rather
than aborting) while the breaker holds the line, and a later attempt
lands after the probe window opens. State changes emit
``breaker.open|half_open|close`` events, trip counters, and a per-key
state gauge. Clock is injectable per-instance; :func:`breaker_for` keeps
one breaker per key (one per model, one per repo host) in a process
registry, mirroring ``faults._ACTIVE`` / the metrics registry.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from mmlspark_tpu_torch.utils import config as mmlconfig
from mmlspark_tpu_torch.utils.logging import get_logger

_LOG = get_logger("reliability.breaker")

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

_STATE_GAUGE = {CLOSED: 0.0, OPEN: 1.0, HALF_OPEN: 0.5}


class CircuitOpen(RuntimeError):
    """Raised instead of calling through while the breaker is open.

    ``retryable = True``: under a ``RetryPolicy`` this backs off and
    retries — by design, so retry-wrapped callers ride out a trip and
    recover through the half-open probe without special-casing.
    """

    retryable = True

    def __init__(self, key: str, retry_in_s: float):
        super().__init__(
            f"circuit {key!r} open; retry in {max(retry_in_s, 0.0):.1f}s")
        self.key = key
        self.retry_in_s = max(retry_in_s, 0.0)


class CircuitBreaker:
    """closed/open/half-open state machine around a failure-prone call.

    Use either form::

        breaker.call(fetch, url)            # wraps + classifies for you

        if breaker.allow():                 # explicit form for call sites
            try: ...                        # that need custom accounting
            except ...: breaker.record_failure()
            else: breaker.record_success()

    ``allow()`` returning True in half-open CLAIMS the single probe slot;
    a caller that then neither records success nor failure would wedge
    the breaker, so ``call()`` is the safer default.
    """

    def __init__(self, key: str, failure_threshold: Optional[int] = None,
                 reset_timeout_s: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.key = key
        self.failure_threshold = int(
            failure_threshold if failure_threshold is not None
            else mmlconfig.get("reliability.breaker_failures"))
        if self.failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.reset_timeout_s = float(
            reset_timeout_s if reset_timeout_s is not None
            else mmlconfig.get("reliability.breaker_reset_s"))
        self.clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0          # consecutive, while closed
        self._opened_at = 0.0
        self._probing = False       # half-open probe slot claimed

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def allow(self) -> bool:
        """May this call proceed? In half-open, True claims the probe."""
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and not self._probing:
                self._probing = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probing = False
            if self._state != CLOSED:
                self._transition(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._probing = False
            if self._state == HALF_OPEN:
                # failed probe: straight back to open, fresh cooldown
                self._opened_at = self.clock()
                self._transition(OPEN)
                return
            self._failures += 1
            if self._state == CLOSED and \
                    self._failures >= self.failure_threshold:
                self._opened_at = self.clock()
                self._transition(OPEN)

    def call(self, fn: Callable, *args, **kwargs):
        """Run ``fn`` through the breaker; any exception counts as a
        failure and propagates."""
        if not self.allow():
            with self._lock:
                retry_in = self._opened_at + self.reset_timeout_s \
                    - self.clock()
            raise CircuitOpen(self.key, retry_in)
        try:
            result = fn(*args, **kwargs)
        except BaseException:
            self.record_failure()
            raise
        self.record_success()
        return result

    def reset(self) -> None:
        """Force-close (tests / operator intervention)."""
        with self._lock:
            self._failures = 0
            self._probing = False
            if self._state != CLOSED:
                self._transition(CLOSED)

    # -- internals (callers hold self._lock) -------------------------------
    def _maybe_half_open(self) -> None:
        if self._state == OPEN and \
                self.clock() - self._opened_at >= self.reset_timeout_s:
            self._transition(HALF_OPEN)

    def _transition(self, state: str) -> None:
        prev, self._state = self._state, state
        _LOG.warning("circuit %r: %s -> %s", self.key, prev, state)
        from mmlspark_tpu_torch.observability import events, metrics
        metrics.gauge(f"reliability.breaker_state.{self.key}").set(
            _STATE_GAUGE[state])
        if state == OPEN:
            metrics.counter("reliability.breaker_trips").inc()
        if events.events_enabled():
            # event names use the transition VERB (breaker.close), not the
            # state adjective — the docs/RELIABILITY.md contract
            verb = "close" if state == CLOSED else state
            events.emit("event", f"breaker.{verb}", key=self.key,
                        prev=prev, failures=self._failures)


_REG_LOCK = threading.Lock()
_BREAKERS: Dict[str, CircuitBreaker] = {}


def breaker_for(key: str, **kwargs) -> CircuitBreaker:
    """One process-wide breaker per key (e.g. ``serve.<model>``,
    ``downloader.<host>``); kwargs apply only on first creation."""
    with _REG_LOCK:
        br = _BREAKERS.get(key)
        if br is None:
            br = _BREAKERS[key] = CircuitBreaker(key, **kwargs)
        return br


def reset_breakers() -> None:
    """Drop all registered breakers (tests)."""
    with _REG_LOCK:
        _BREAKERS.clear()
