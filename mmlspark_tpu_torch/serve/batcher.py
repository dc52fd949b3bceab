"""Deadline-aware dynamic micro-batching core (pure logic, no threads).

The port's copy of ``mmlspark_tpu/serve/batcher.py``: the same code.

The coalescing policy of the serving subsystem, factored out of the
:class:`~mmlspark_tpu_torch.serve.server.Server` executor thread so tests drive it
with an injected clock and zero sleeps: admitted requests (:class:`Ticket`)
queue in arrival order, and a batch flushes when EITHER

- the head group reaches ``max_batch`` rows (occupancy-driven flush), or
- the oldest pending ticket has waited ``max_wait_s`` (deadline-driven
  flush — a lone request is never stranded behind an empty batch).

Batches are single-model: a group is the maximal run of consecutive
same-model tickets from the head, so multi-model traffic interleaves in
FIFO order without ever mixing two models' rows in one device program.

Bucketing: flushed groups pad to the smallest configured bucket that fits
(:func:`bucket_for`), so the jitted apply sees a SMALL FIXED SET of batch
shapes and builds one program (a CUDA graph) per bucket — never per
request, never per occupancy. This is the serving-side face of the
one-shape discipline ``TorchModel.transform`` applies to final-batch
padding.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, List, Optional, Sequence, Tuple


class Ticket:
    """One admitted request: ``rows`` coerced examples bound for ``model``,
    plus the future its caller is blocked on. ``enqueued`` and ``deadline``
    are absolute times on the server's (injectable) clock; ``deadline``
    None means the request never expires. ``trace_id`` is minted at
    admission and rides through shed/expired/request events (and the
    tail-sampled span timeline) so one request's records correlate."""

    __slots__ = ("model", "x", "rows", "future", "enqueued", "deadline",
                 "trace_id")

    def __init__(self, model: str, x, rows: int, future,
                 enqueued: float, deadline: Optional[float] = None,
                 trace_id: str = ""):
        self.model = model
        self.x = x
        self.rows = rows
        self.future = future
        self.enqueued = enqueued
        self.deadline = deadline
        self.trace_id = trace_id

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline


def default_buckets(max_batch: int) -> Tuple[int, ...]:
    """The default bucket ladder: {1, max/8, max/2, max} (deduped) — four
    compiles covering lone requests, trickle traffic, and full batches.
    A geometric ladder wastes at most ~2x padding compute in the worst
    case while keeping compile count (and HBM program cache) small."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    return tuple(sorted({1, max(1, max_batch // 8),
                         max(1, max_batch // 2), max_batch}))


def parse_buckets(text: str, max_batch: int) -> Tuple[int, ...]:
    """``serving.buckets`` config ("1,8,64") -> validated ascending tuple.
    The largest bucket must cover ``max_batch`` or a full flush could not
    be padded to any compiled shape."""
    vals = sorted({int(v) for v in text.split(",") if v.strip()})
    if not vals:
        return default_buckets(max_batch)
    if any(v < 1 for v in vals):
        raise ValueError(f"buckets must be >= 1, got {vals}")
    if vals[-1] < max_batch:
        raise ValueError(
            f"largest bucket {vals[-1]} < max_batch {max_batch}; a full "
            "batch would have no compiled shape to pad to")
    return tuple(vals)


def bucket_for(rows: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that fits ``rows`` (buckets ascending)."""
    for b in buckets:
        if rows <= b:
            return b
    raise ValueError(f"{rows} rows exceed the largest bucket {buckets[-1]}")


class MicroBatcher:
    """FIFO coalescer with the two-trigger flush policy above.

    Not thread-safe by itself — the server's single executor thread is the
    only caller, which is also what makes hit order (and therefore fault
    replay) deterministic.
    """

    def __init__(self, max_batch: int, max_wait_s: float,
                 clock: Callable[[], float] = time.monotonic):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.clock = clock
        self._pending: "deque[Ticket]" = deque()

    def __len__(self) -> int:
        return len(self._pending)

    @property
    def pending_rows(self) -> int:
        return sum(t.rows for t in self._pending)

    def offer(self, ticket: Ticket) -> None:
        if ticket.rows > self.max_batch:
            # submit_many splits oversized requests before admission; a
            # ticket this size is a caller bug, surfaced loudly
            raise ValueError(
                f"ticket of {ticket.rows} rows exceeds max_batch "
                f"{self.max_batch}")
        self._pending.append(ticket)

    def _head_group_rows(self) -> int:
        """Rows in the maximal consecutive same-model run from the head,
        capped at max_batch (the flushable group)."""
        rows = 0
        model = None
        for t in self._pending:
            if model is None:
                model = t.model
            elif t.model != model:
                break
            if rows + t.rows > self.max_batch:
                break
            rows += t.rows
        return rows

    def ready(self, now: Optional[float] = None) -> bool:
        """Should the head group flush now?"""
        if not self._pending:
            return False
        if now is None:
            now = self.clock()
        if self._head_group_rows() >= self.max_batch:
            return True
        return now - self._pending[0].enqueued >= self.max_wait_s

    def wait_s(self, now: Optional[float] = None) -> Optional[float]:
        """Seconds until the oldest ticket forces a deadline flush, or
        None when nothing is pending (block indefinitely)."""
        if not self._pending:
            return None
        if now is None:
            now = self.clock()
        return max(0.0, self.max_wait_s - (now - self._pending[0].enqueued))

    def take(self, now: Optional[float] = None) -> List[Ticket]:
        """Pop the head group (same model, <= max_batch rows, arrival
        order). Empty list when nothing is pending. Expiry is NOT filtered
        here — the server cancels expired tickets at dequeue so the
        cancellation is observable (counted, evented) in one place."""
        group: List[Ticket] = []
        rows = 0
        while self._pending:
            head = self._pending[0]
            if group and head.model != group[0].model:
                break
            if rows + head.rows > self.max_batch:
                break
            group.append(self._pending.popleft())
            rows += head.rows
        return group
