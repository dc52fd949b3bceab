"""Retry/backoff primitives for self-healing I/O.

The port's copy of ``mmlspark_tpu/reliability/retry.py``, unchanged but
for its imports.

The reference delegated fault tolerance to Spark's task retry and CNTK's MPI
restart; this TPU-native reproduction owns its training loop and I/O, so it
owns retry too. ``RetryPolicy`` is the one retry implementation every
subsystem shares (downloader MANIFEST/model fetches, future elastic-pod
paths): exponential backoff with DETERMINISTIC jitter (seeded hash, no
global RNG — a retried test run replays bit-for-bit), a max-attempt cap, an
optional overall deadline, and a retryable-exception predicate.

Three call shapes::

    policy = RetryPolicy(max_attempts=4, base_delay=0.2)

    @policy                       # decorator
    def fetch(url): ...

    policy.call(fetch, url)       # direct call

    for attempt in policy.attempts():   # context-manager loop (tenacity
        with attempt:                   # style) for multi-statement bodies
            data = fetch(url)

Every retry logs through the framework logger tree
(``mmlspark_tpu_torch.reliability.retry``), so backoff activity is observable at
the same place as training metrics.
"""
from __future__ import annotations

import functools
import hashlib
import time
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

from mmlspark_tpu_torch.utils.logging import get_logger

_LOG = get_logger("reliability.retry")


def default_retryable(exc: BaseException) -> bool:
    """Transient-I/O default: the OSError family retries (URLError,
    ConnectionError, socket timeouts, truncated-read IOErrors), EXCEPT
    definitive HTTP client errors — a 404 will 404 again, but a 429 or any
    5xx is the server asking for a retry.

    Beyond I/O, any exception may opt in by carrying a truthy
    ``retryable`` attribute — the protocol load-shedding errors use
    (``serve.ServerOverloaded`` sets ``retryable = True`` as a class
    attribute) so new transient failure types classify correctly here
    without this module importing their packages."""
    from urllib.error import HTTPError
    if isinstance(exc, HTTPError):
        return exc.code == 429 or exc.code >= 500
    if isinstance(exc, (OSError, TimeoutError)):
        return True
    return bool(getattr(exc, "retryable", False))


def _unit(seed: int, attempt: int) -> float:
    """Deterministic uniform in [0, 1): sha256 of (seed, attempt)."""
    digest = hashlib.sha256(f"{seed}:{attempt}".encode()).digest()
    return int.from_bytes(digest[:8], "big") / 2 ** 64


class Attempt:
    """One try of a :meth:`RetryPolicy.attempts` loop. ``__exit__`` decides
    whether the raised exception is swallowed (retry) or propagates."""

    __slots__ = ("policy", "number", "_started", "succeeded", "exception")

    def __init__(self, policy: "RetryPolicy", number: int, started: float):
        self.policy = policy
        self.number = number
        self._started = started
        self.succeeded = False
        self.exception: Optional[BaseException] = None

    def __enter__(self) -> "Attempt":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self.succeeded = True
            return False
        self.exception = exc
        p = self.policy
        if self.number >= p.max_attempts or not p.retryable(exc):
            return False
        delay = p.delay(self.number)
        # Retry-After protocol: an exception carrying a positive numeric
        # ``retry_after`` (seconds — HttpRepo parses the 429/503 header
        # into it, CircuitOpen sets retry_in_s) RAISES the delay to the
        # server's ask; the deadline check below still caps the total, so
        # an absurd header gives up rather than oversleeping the budget.
        hinted = getattr(exc, "retry_after", None)
        if hinted is None:
            hinted = getattr(exc, "retry_in_s", None)
        try:
            if hinted is not None and float(hinted) > delay:
                delay = float(hinted)
        except (TypeError, ValueError):
            pass
        if p.deadline is not None and \
                (p.clock() - self._started) + delay > p.deadline:
            _LOG.warning(
                "%s: attempt %d/%d failed (%s: %s); deadline %.1fs would be "
                "exceeded, giving up", p.name, self.number, p.max_attempts,
                type(exc).__name__, exc, p.deadline)
            return False
        _LOG.warning("%s: attempt %d/%d failed (%s: %s); retrying in %.2fs",
                     p.name, self.number, p.max_attempts,
                     type(exc).__name__, exc, delay)
        # retries are cold-path by definition; the counter is unconditional,
        # the event only when an events path is configured
        from mmlspark_tpu_torch.observability import events, metrics as obsmetrics
        obsmetrics.counter("reliability.retry_attempts").inc()
        if events.events_enabled():
            events.emit("event", "retry.attempt", policy=p.name,
                        attempt=self.number, delay_s=round(delay, 4),
                        error=f"{type(exc).__name__}: {exc}")
        if p.on_retry is not None:
            p.on_retry(self.number, exc, delay)
        p.sleep(delay)
        return True


@dataclass
class RetryPolicy:
    """Exponential backoff with deterministic jitter.

    Attempt ``n`` (1-based) that fails sleeps
    ``min(base_delay * multiplier**(n-1), max_delay)`` scaled by a seeded
    jitter in ``[1-jitter, 1+jitter]`` before attempt ``n+1``. ``deadline``
    bounds the TOTAL elapsed time: a retry whose sleep would cross it gives
    up immediately instead. ``retryable(exc) -> bool`` gates which failures
    retry at all (default: transient-I/O, :func:`default_retryable`).
    ``sleep``/``clock`` are injectable for tests; ``on_retry(attempt, exc,
    delay)`` is an optional per-retry hook on top of the built-in logging.
    """

    max_attempts: int = 3
    base_delay: float = 0.2
    max_delay: float = 30.0
    multiplier: float = 2.0
    jitter: float = 0.1
    deadline: Optional[float] = None
    retryable: Callable[[BaseException], bool] = default_retryable
    seed: int = 0
    name: str = "retry"
    sleep: Callable[[float], None] = time.sleep
    clock: Callable[[], float] = time.monotonic
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None

    def delay(self, attempt: int) -> float:
        """Backoff before the attempt AFTER 1-based ``attempt`` fails."""
        base = min(self.base_delay * self.multiplier ** (attempt - 1),
                   self.max_delay)
        scale = 1.0 + self.jitter * (2.0 * _unit(self.seed, attempt) - 1.0)
        return max(base * scale, 0.0)

    def attempts(self) -> Iterator[Attempt]:
        """Yield :class:`Attempt` context managers until one succeeds, a
        non-retryable/final failure propagates, or the deadline passes."""
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got "
                             f"{self.max_attempts}")
        started = self.clock()
        number = 0
        while True:
            number += 1
            attempt = Attempt(self, number, started)
            yield attempt
            if attempt.succeeded:
                return
            if attempt.exception is None:
                raise RuntimeError(
                    "attempt was never entered; use `with attempt:` inside "
                    "the attempts() loop")

    def call(self, fn: Callable, *args, **kwargs):
        """Run ``fn(*args, **kwargs)`` under this policy, returning its
        result; the last exception propagates when retries are exhausted."""
        for attempt in self.attempts():
            with attempt:
                return fn(*args, **kwargs)
        raise AssertionError("unreachable: attempts() ended without success")

    def __call__(self, fn: Callable) -> Callable:
        """Decorator form: ``@RetryPolicy(...)``."""
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return self.call(fn, *args, **kwargs)
        wrapped.retry_policy = self
        return wrapped
