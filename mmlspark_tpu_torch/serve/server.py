"""In-process inference server: admission -> micro-batch -> score -> respond.

The port of ``mmlspark_tpu/serve/server.py``, with the same shape:

- **Admission** (caller threads): inputs are coerced through the model's
  own ``_coerce_batch`` (the offline ``transform`` path's coercion),
  wrapped in a :class:`~mmlspark_tpu_torch.serve.batcher.Ticket` and
  pushed into a BOUNDED queue. A full queue rejects immediately with
  :class:`ServerOverloaded` (``retryable = True`` — ``RetryPolicy``'s
  default classifier backs off and retries it) instead of growing latency
  unboundedly: shed early, shed cheap.
- **One executor thread** owns the scoring path: it drains the queue into
  a :class:`~mmlspark_tpu_torch.serve.batcher.MicroBatcher`, flushes on
  ``max_batch``/``max_wait_ms``, cancels tickets whose deadline passed
  while queued (:class:`RequestExpired` — never scored), pads the group to
  a bucket, and scores it through the
  :class:`~mmlspark_tpu_torch.serve.registry.ModelRegistry`: on a CUDA
  device one replay of that bucket's CUDA graph. Single ownership means a
  deterministic batch sequence for fault replay.
- **Telemetry**: admitted/shed/expired/completed counters are
  unconditional; queue-depth + batch-occupancy gauges and the
  queue/pad/compute latency histograms gate on ``metrics_enabled()``; one
  ``serving.request`` event per request and ``serving.shed`` /
  ``serving.expired`` events gate on the event log. The ``serving.summary``
  event written at close carries ``device``: this process's kernel launch
  counts, every generate-lane program's replays and recorded launches, its
  device memory and its TF32 setting, so a worker process's launches can
  be read after it drained.
- **Fault sites** ``serve.enqueue`` / ``serve.batch`` / ``serve.score``
  let a FaultPlan replay overload and mid-batch-crash scenarios
  deterministically (a ``serve.score`` raise fails that batch's futures
  and the executor keeps serving).

The server runs on ``runtime.device``, resolved at construction: it raises
when that names CUDA and there is none.
"""
from __future__ import annotations

import itertools
import os
import queue
import threading
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import numpy as np

from mmlspark_tpu_torch.observability import events, metrics, spans
from mmlspark_tpu_torch.reliability import watchdog as _watchdog
from mmlspark_tpu_torch.reliability.faults import fault_site
from mmlspark_tpu_torch.serve.batcher import (
    MicroBatcher, Ticket, bucket_for, default_buckets, parse_buckets,
)
from mmlspark_tpu_torch.serve.registry import ModelRegistry
from mmlspark_tpu_torch.utils import config as mmlconfig
from mmlspark_tpu_torch.utils.logging import get_logger

logger = get_logger("serve")

_STOP = object()

# request trace ids: per-process counter + pid, so merged multi-replica
# logs never collide and an id is greppable end to end (shed/expired/
# request events, tail-sampled spans, histogram exemplars, HTTP response)
_trace_ids = itertools.count(1)
_trace_lock = threading.Lock()


def _mint_trace_id() -> str:
    with _trace_lock:
        n = next(_trace_ids)
    return f"t-{os.getpid():x}-{n:x}"


class ServeError(RuntimeError):
    """Base for serving-path failures."""


class ServerOverloaded(ServeError):
    """Admission rejected: the bounded queue is full. Retryable by
    contract — ``reliability.retry.default_retryable`` reads this class
    attribute, so a client wrapping ``submit`` in ``RetryPolicy`` backs
    off and retries without custom classification.

    ``retry_after`` (seconds, or None) is the server's backoff ask: the
    HTTP front-end maps it to the ``Retry-After`` header, the retry layer
    reads it through the ``retry_after`` attribute protocol, and the
    fleet router consolidates the MINIMUM across replicas when every
    replica sheds (come back when the soonest one frees up)."""
    retryable = True

    def __init__(self, msg: str, retry_after: Optional[float] = None):
        super().__init__(msg)
        self.retry_after = retry_after


class RequestExpired(ServeError):
    """The request's deadline passed before scoring started; it was
    cancelled at dequeue, not computed. NOT retryable by default — the
    caller's deadline already elapsed, retrying is their call."""


class ServerClosed(ServeError):
    """Submitted to a server after ``close()``."""


class _Twin:
    """A per-instance counter that also feeds the process-wide metric of
    the same name: ``value`` is THIS server's count (stats()/inflight for
    one fleet replica), the registry counter stays the process aggregate
    the exposition endpoint and existing dashboards read."""

    __slots__ = ("_local", "_global")

    def __init__(self, name: str):
        self._local = metrics.Counter(name)
        self._global = metrics.counter(name)

    def inc(self, n: float = 1.0) -> None:
        self._local.inc(n)
        self._global.inc(n)

    @property
    def value(self) -> float:
        return self._local.value


class Server:
    """Dynamic micro-batching inference server over a model registry.

    ``models`` maps serving names to fitted
    :class:`~mmlspark_tpu_torch.models.torch_model.TorchModel`-like stages
    (anything with ``_spec``/``_coerce_batch``/``_device_apply``). They
    are served on ``runtime.device``. Knobs default from
    the ``serving.*`` config namespace. ``start=False`` leaves the
    executor unstarted — tests drive admission and ``_flush`` directly
    for deterministic overload/expiry coverage.
    """

    def __init__(self, models: Dict[str, object], *,
                 max_batch: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 buckets: Optional[Sequence[int]] = None,
                 clock=None, start: bool = True):
        self.max_batch = int(max_batch if max_batch is not None
                             else mmlconfig.get("serving.max_batch"))
        wait_ms = float(max_wait_ms if max_wait_ms is not None
                        else mmlconfig.get("serving.max_wait_ms"))
        self.max_wait_s = wait_ms / 1e3
        depth = int(queue_depth if queue_depth is not None
                    else mmlconfig.get("serving.queue_depth"))
        if buckets is None:
            text = str(mmlconfig.get("serving.buckets"))
            self.buckets = parse_buckets(text, self.max_batch) if text \
                else default_buckets(self.max_batch)
        else:
            self.buckets = tuple(sorted(set(int(b) for b in buckets)))
            if self.buckets[-1] < self.max_batch:
                raise ValueError(
                    f"largest bucket {self.buckets[-1]} < max_batch "
                    f"{self.max_batch}")
        self.clock = clock if clock is not None else events.perf
        self.device = mmlconfig.resolve_device()
        self.registry = ModelRegistry(device=self.device)
        for name, model in models.items():
            self.registry.add(name, model)
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._batcher = MicroBatcher(self.max_batch, self.max_wait_s,
                                     clock=self.clock)
        # _admit serializes the admission-state check against the enqueue
        # AND against close()/drain() flipping that state: without it a
        # ticket could pass the check, lose the CPU, and be enqueued after
        # the executor drained — a future nobody will ever resolve.
        self._admit = threading.Lock()
        self._closed = False
        self._draining = False
        self._thread: Optional[threading.Thread] = None
        # counters are unconditional (lock + int add); gauges/histograms
        # gate per-use on metrics_enabled(). The metrics registry is
        # process-wide — with N in-process fleet replicas those counters
        # aggregate — so per-instance Counter twins back stats()/inflight.
        self._admitted = _Twin("serving.admitted")
        self._shed = _Twin("serving.shed")
        self._expired = _Twin("serving.expired")
        self._completed = _Twin("serving.completed")
        self._failed = _Twin("serving.failed")
        # per-instance latency histogram: the process-wide
        # serving.total_ms aggregates across in-process fleet replicas,
        # but the fleet scraper and stats() need THIS replica's p50/p99
        self._latency = metrics.Histogram("serving.total_ms",
                                          metrics.MS_BUCKETS)
        # generative lanes (serve/generate.py), one per decoder-LM model,
        # created lazily on the first submit_generate
        self._lanes: Dict[str, object] = {}
        self._autostart = start
        if start:
            self.start()

    @staticmethod
    def _twin(name: str) -> _Twin:
        """Per-instance + process-global counter pair (the generative lane
        counts through the same twin scheme as the scoring path)."""
        return _Twin(name)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="mmlspark-tpu-torch-serve", daemon=True)
        self._thread.start()

    def close(self, drain: bool = True,
              timeout_s: Optional[float] = None) -> None:
        """Stop the executor. ``drain=True`` scores everything already
        admitted first; ``drain=False`` fails pending work with a
        retryable :class:`ServerOverloaded` (shed to another replica, not
        a hang). Idempotent and race-safe: the second call is a no-op,
        and the admission lock guarantees no ticket slips into the queue
        after the executor stops — every admitted future resolves.
        ``timeout_s`` bounds the executor join (default
        ``serving.drain_timeout_s``)."""
        with self._admit:
            if self._closed:
                return
            self._closed = True
            self._draining = True
        if timeout_s is None:
            timeout_s = float(mmlconfig.get("serving.drain_timeout_s"))
        # a closed lane drops its programs: hold them for the summary
        programs = self._lane_programs() if events.events_enabled() else []
        for lane in list(self._lanes.values()):
            lane.close(timeout_s=timeout_s)
        if self._thread is not None:
            self._queue.put(_STOP)
            self._thread.join(timeout=max(timeout_s, 0.1))
            if self._thread.is_alive():
                logger.warning("serve executor did not stop within %.1fs",
                               timeout_s)
            self._thread = None
        leftovers = [t for t in self._drain_tickets() if t is not _STOP]
        if drain:
            for t in leftovers:
                self._batcher.offer(t)
            while len(self._batcher):
                self._flush()
        else:
            while len(self._batcher):
                leftovers.extend(self._batcher.take())
            for t in leftovers:
                if not t.future.done():
                    self._failed.inc()
                    t.future.set_exception(ServerOverloaded(
                        "server closed before scoring; retry elsewhere",
                        retry_after=1.0))
        # the ledger reconciles on close: a dead replica's param/table/kv
        # lines must not linger in the device-memory ledger
        self.registry.release()
        if events.events_enabled():
            s = self.stats()
            events.emit("serving", "summary",
                        device=_device_report(programs), **s)

    def drain(self, timeout_s: Optional[float] = None,
              reason: str = "drain") -> None:
        """Graceful shutdown for preemption: stop admission FIRST (new
        submits shed with retryable :class:`ServerOverloaded`, the HTTP
        front-end maps that to 503 + ``Retry-After``), finish everything
        already admitted, then close. ``timeout_s`` defaults to
        ``serving.drain_timeout_s``. Idempotent."""
        with self._admit:
            if self._closed:
                return
            already = self._draining
            self._draining = True
        if not already:
            logger.warning("serve: draining (%s); admission stopped", reason)
            metrics.counter("serving.drains").inc()
            if events.events_enabled():
                events.emit("event", "preemption.drain", kind="serve",
                            reason=reason,
                            pending=self._queue.qsize() +
                            len(self._batcher))
        self.close(drain=True, timeout_s=timeout_s)

    def check_device(self) -> None:
        """Resolve ``runtime.device`` as every entry point does: raise when
        it names a missing card or a device other than the server's."""
        device = mmlconfig.resolve_device()
        if device != self.device:
            raise RuntimeError(
                f"runtime.device is {str(device)!r} but this server runs "
                f"on {str(self.device)!r}")

    @property
    def draining(self) -> bool:
        return self._draining and not self._closed

    def health(self) -> Dict[str, object]:
        """Liveness vs readiness, split (the k8s-probe distinction the
        fleet router routes on): a DRAINING server is still ``live`` —
        in-flight work finishes, ``/healthz`` answers — but no longer
        ``ready`` for new traffic, so the router rotates it out BEFORE it
        stops being alive. ``state`` is one of ``ready``/``draining``/
        ``closed``."""
        if self._closed:
            state = "closed"
        elif self._draining:
            state = "draining"
        else:
            state = "ready"
        return {"live": not self._closed, "ready": state == "ready",
                "state": state}

    @property
    def inflight(self) -> int:
        """Requests admitted but not yet resolved (completed, expired, or
        failed) — the rollout drain condition."""
        n = self._admitted.value - self._completed.value \
            - self._expired.value - self._failed.value
        return max(0, int(round(n)))

    @property
    def capacity_rows(self) -> int:
        """Admission headroom (the bounded-queue depth, i.e. in-flight
        requests this replica holds before shedding): the fleet fairness
        layer sizes tenant shares from the sum of replica capacities."""
        return self._queue.maxsize

    def __enter__(self) -> "Server":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- submission (caller threads) --------------------------------------
    def submit_async(self, model: str, x,
                     deadline_ms: Optional[float] = None, *,
                     trace_id: Optional[str] = None) -> Future:
        """Admit one request (a single example or a small batch of rows up
        to ``max_batch``); returns a Future resolving to the scored rows
        (float32, one row per input row). Raises :class:`ServerOverloaded`
        synchronously when the queue is full. ``trace_id`` lets a fleet
        router thread ONE id through a failover chain — when None the
        server mints its own."""
        if self._closed:
            raise ServerClosed("server closed")
        if self._draining:
            raise ServerOverloaded("server draining; retry elsewhere",
                                   retry_after=1.0)
        entry = self.registry.get(model)   # KeyError surfaces here, early
        arr = np.asarray(x)
        if arr.ndim == 1:
            arr = arr[None, :]
        coerced = entry.coerce(arr)
        if coerced.shape[0] > self.max_batch:
            raise ValueError(
                f"{coerced.shape[0]} rows > max_batch {self.max_batch}; "
                "use submit_many for large arrays")
        now = self.clock()
        if deadline_ms is None:
            dms = float(mmlconfig.get("serving.default_deadline_ms"))
            deadline_ms = dms if dms > 0 else None
        deadline = now + deadline_ms / 1e3 if deadline_ms else None
        ticket = Ticket(model, coerced, coerced.shape[0], Future(),
                        enqueued=now, deadline=deadline,
                        trace_id=trace_id or _mint_trace_id())
        # callers (the HTTP front-end) read the id off the future they
        # already hold — no parallel return channel needed
        ticket.future.trace_id = ticket.trace_id
        fault_site("serve.enqueue", {"model": model,
                                     "rows": ticket.rows})
        try:
            # check-and-enqueue is atomic against close()/drain(): a
            # ticket is either in the queue BEFORE the stop sentinel (the
            # executor or close() resolves it) or rejected here — never
            # admitted into a stopped server.
            with self._admit:
                if self._closed:
                    raise ServerClosed("server closed")
                if self._draining:
                    raise ServerOverloaded(
                        "server draining; retry elsewhere",
                        retry_after=1.0)
                self._queue.put_nowait(ticket)
        except queue.Full:
            self._shed.inc()
            if events.recording_enabled():
                events.emit("serving", "shed", model=model,
                            rows=ticket.rows, trace_id=ticket.trace_id)
            raise ServerOverloaded(
                f"queue full ({self._queue.maxsize} pending); retry with "
                "backoff",
                retry_after=float(
                    mmlconfig.get("serving.retry_after_s"))) from None
        self._admitted.inc()
        if metrics.metrics_enabled():
            metrics.gauge("serving.queue_depth").set(self._queue.qsize())
        return ticket.future

    def submit(self, model: str, x,
               deadline_ms: Optional[float] = None,
               timeout: Optional[float] = None) -> np.ndarray:
        """Blocking :meth:`submit_async`."""
        return self.submit_async(model, x, deadline_ms).result(timeout)

    # -- generative lane ---------------------------------------------------
    def enable_generate(self, model: str, *, clock=None,
                        start: Optional[bool] = None):
        """Create (or return) the generative lane for ``model`` — its own
        executor thread, KV arena, and bucketed prefill/decode programs
        (see :mod:`~mmlspark_tpu_torch.serve.generate`). Lazy: plain
        scoring servers never pay for an arena. ``start=False`` leaves the
        lane thread unstarted for test-driven stepping. Raises as
        :meth:`check_device` does."""
        from mmlspark_tpu_torch.serve.generate import GenerateLane
        self.check_device()
        with self._admit:
            if self._closed:
                raise ServerClosed("server closed")
            lane = self._lanes.get(model)
            if lane is None:
                lane = GenerateLane(
                    self, model, clock=clock,
                    start=self._autostart if start is None else start)
                self._lanes[model] = lane
        return lane

    def reset_lane(self, model: str,
                   timeout_s: Optional[float] = None) -> bool:
        """Close and forget the generate lane for ``model`` (False when
        it has none). A lane's KV arena and programs are bound to the entry
        it was built against, so after a ``registry.replace`` the old lane
        must die — the next ``submit_generate`` (or an explicit
        ``enable_generate``) builds a fresh lane against the CURRENT
        entry. Closing fails unfinished sequences with ``ServerClosed``;
        a caller restarts them from their prompts, token-identically under
        seeded sampling."""
        with self._admit:
            lane = self._lanes.pop(model, None)
        if lane is None:
            return False
        lane.close(timeout_s=timeout_s)
        return True

    def submit_generate(self, model: str, prompt,
                        max_new_tokens: Optional[int] = None, *,
                        temperature: float = 0.0, top_k: int = 0,
                        seed: int = 0, eos_id: Optional[int] = None,
                        deadline_ms: Optional[float] = None,
                        trace_id: Optional[str] = None) -> Future:
        """Admit one generation request; the Future resolves to a dict
        with ``tokens`` (sampled ids), ``finish_reason``, ``ttft_ms`` and
        ``trace_id``. Sheds with retryable :class:`ServerOverloaded` when
        the KV arena cannot hold the sequence's full block budget."""
        from mmlspark_tpu_torch.serve.generate import GenerateRequest
        if self._closed:
            raise ServerClosed("server closed")
        if self._draining:
            raise ServerOverloaded("server draining; retry elsewhere",
                                   retry_after=1.0)
        self.registry.get(model)   # KeyError surfaces here, early
        if max_new_tokens is None:
            max_new_tokens = int(mmlconfig.get("generate.max_new_tokens"))
        lane = self.enable_generate(model)
        return lane.submit(GenerateRequest(
            model=model, prompt=prompt, max_new_tokens=max_new_tokens,
            temperature=temperature, top_k=top_k, seed=seed,
            eos_id=eos_id, deadline_ms=deadline_ms,
            trace_id=trace_id or ""))

    def generate(self, model: str, prompt,
                 max_new_tokens: Optional[int] = None,
                 timeout: Optional[float] = None, **kw) -> Dict:
        """Blocking :meth:`submit_generate`."""
        return self.submit_generate(model, prompt, max_new_tokens,
                                    **kw).result(timeout)

    def submit_many(self, model: str, x,
                    deadline_ms: Optional[float] = None,
                    timeout: Optional[float] = None) -> np.ndarray:
        """Score a large array by splitting it into ``max_batch``-row
        requests admitted back-to-back (they coalesce into full batches),
        then reassembling in order."""
        arr = np.asarray(x)
        if arr.ndim == 1:
            arr = arr[None, :]
        futures = [self.submit_async(model, arr[i:i + self.max_batch],
                                     deadline_ms)
                   for i in range(0, arr.shape[0], self.max_batch)]
        return np.concatenate([f.result(timeout) for f in futures], axis=0)

    def pump(self, max_batches: Optional[int] = None) -> int:
        """Synchronously run the executor's coalesce+flush step on the
        CALLER's thread: drain every queued ticket into the batcher, then
        flush up to ``max_batches`` groups (all of them when ``None``).
        Returns the number of groups flushed.

        This is the deterministic drive for ``start=False`` servers: the
        request schedule is a pure function of the caller's order. Unscored
        backlog stays in the BOUNDED queue (only the rows each flushed
        group can take are drained), so ``queue_depth`` remains an honest
        backpressure signal between pumps. Calling it on a started server
        is unsupported (two executors would race for the same batcher)."""
        if self._closed:
            raise ServerClosed("server closed")
        done = 0
        while max_batches is None or done < max_batches:
            rows = 0
            while rows < self.max_batch:
                try:
                    t = self._queue.get_nowait()
                except queue.Empty:
                    break
                if t is _STOP:
                    continue
                self._batcher.offer(t)
                rows += t.rows
            if not len(self._batcher):
                break
            self._flush()
            done += 1
        if metrics.metrics_enabled():
            metrics.gauge("serving.queue_depth").set(self._queue.qsize())
        return done

    # -- executor ----------------------------------------------------------
    def _run(self) -> None:
        # liveness: the executor beats once per loop pass; the idle wait
        # is bounded (never a blocking get(None)) so an EMPTY server still
        # beats and only a wedged flush reads as a stall
        hb = _watchdog.register("serve.executor")
        try:
            self._run_loop(hb)
        finally:
            hb.close()

    def _run_loop(self, hb) -> None:
        stopping = False
        while True:
            hb.beat()
            wait = self._batcher.wait_s()
            wait = 0.5 if wait is None else min(wait, 0.5)
            try:
                with spans.span("serve", "wait", hot=True):
                    item = self._queue.get(timeout=wait)
            except queue.Empty:
                item = None          # deadline flush fires below
            if item is _STOP:
                stopping = True
            elif item is not None:
                self._batcher.offer(item)
            # opportunistic drain: everything already queued joins this
            # coalescing round without further blocking
            for t in self._drain_tickets():
                if t is _STOP:      # pragma: no cover - close() races
                    stopping = True
                else:
                    self._batcher.offer(t)
            if metrics.metrics_enabled():
                metrics.gauge("serving.queue_depth").set(self._queue.qsize())
            while self._batcher.ready() \
                    or (stopping and len(self._batcher)):
                self._flush()
            if stopping:
                return

    def _drain_tickets(self) -> List:
        out: List = []
        while True:
            try:
                out.append(self._queue.get_nowait())
            except queue.Empty:
                return out

    def _flush(self) -> None:
        """Dequeue one head group, cancel expired tickets, pad to a
        bucket, score, resolve futures. Any failure fails THIS group's
        futures and leaves the executor serving. One hot ``serve:batch``
        span, its stages ``batch:take``, ``batch:pad``, the program's
        ``batch:copy_in``, ``batch:replay`` and ``batch:fetch``
        (``serve/programs.py``), and ``batch:respond``."""
        with spans.span("serve", "batch", hot=True) as batch:
            with spans.span("batch", "take", hot=True):
                t_dequeue = self.clock()
                live = self._cancel_expired(self._batcher.take(), t_dequeue)
            if live:
                self._score_group(live, t_dequeue, batch)

    def _cancel_expired(self, group: List[Ticket],
                        t_dequeue: float) -> List[Ticket]:
        """``group`` without the tickets whose deadline passed, which are
        failed with :class:`RequestExpired`."""
        live: List[Ticket] = []
        for t in group:
            if t.expired(t_dequeue):
                self._expired.inc()
                if events.recording_enabled():
                    events.emit("serving", "expired", model=t.model,
                                rows=t.rows, trace_id=t.trace_id,
                                waited_ms=round(
                                    (t_dequeue - t.enqueued) * 1e3, 3))
                t.future.set_exception(RequestExpired(
                    f"deadline passed {t_dequeue - t.deadline:.3f}s before "
                    "scoring"))
            else:
                live.append(t)
        return live

    def _score_group(self, live: List[Ticket], t_dequeue: float,
                     batch) -> None:
        try:
            rows = sum(t.rows for t in live)
            fault_site("serve.batch", {"model": live[0].model,
                                       "tickets": len(live), "rows": rows})
            bucket = bucket_for(rows, self.buckets)
            batch.set(rows=rows, bucket=bucket, tickets=len(live))
            with spans.span("batch", "pad", hot=True):
                x = np.concatenate([t.x for t in live], axis=0) \
                    if len(live) > 1 else live[0].x
                if rows < bucket:
                    pad = np.zeros((bucket - rows,) + x.shape[1:], x.dtype)
                    x = np.concatenate([x, pad], axis=0)
            t_padded = self.clock()
            entry = self.registry.get(live[0].model)
            entry.ensure_apply()
            self.registry.touch(entry)
            fault_site("serve.score", {"model": entry.name,
                                       "bucket": bucket})
            out = entry.score(x)
            t_scored = self.clock()
            with spans.span("batch", "respond", hot=True):
                self._respond(live, out, bucket, rows,
                              t_dequeue, t_padded, t_scored)
        except Exception as e:  # fail the group, keep serving
            logger.error("serve batch failed: %s", e)
            for t in live:
                if not t.future.done():
                    self._failed.inc()
                    t.future.set_exception(e)

    def _respond(self, live: List[Ticket], out: np.ndarray, bucket: int,
                 rows: int, t_dequeue: float, t_padded: float,
                 t_scored: float) -> None:
        hot = metrics.metrics_enabled()
        ms = metrics.MS_BUCKETS
        log = events.recording_enabled()
        slow_ms = float(mmlconfig.get("observability.trace_slow_ms") or 0.0)
        pad_s = t_padded - t_dequeue
        compute_s = t_scored - t_padded
        if hot:
            metrics.gauge("serving.batch_occupancy").set(rows / bucket)
            metrics.histogram("serving.pad_ms", ms).observe(pad_s * 1e3)
            metrics.histogram("serving.compute_ms", ms).observe(
                compute_s * 1e3)
        offset = 0
        for t in live:
            res = out[offset:offset + t.rows]
            offset += t.rows
            queue_s = t_dequeue - t.enqueued
            total_s = t_scored - t.enqueued
            # tail sampling: only requests over the threshold pay for full
            # span detail; everyone else keeps the one cheap request event
            slow = slow_ms > 0 and total_s * 1e3 >= slow_ms
            self._completed.inc()
            if hot:
                ex = t.trace_id if slow else None
                metrics.histogram("serving.queue_ms", ms).observe(
                    queue_s * 1e3, exemplar=ex)
                metrics.histogram("serving.total_ms", ms).observe(
                    total_s * 1e3, exemplar=ex)
                self._latency.observe(total_s * 1e3, exemplar=ex)
            if log:
                events.emit("serving", "request", model=t.model,
                            rows=t.rows, bucket=bucket,
                            trace_id=t.trace_id, slow=slow,
                            occupancy=round(rows / bucket, 4),
                            queue_ms=round(queue_s * 1e3, 3),
                            pad_ms=round(pad_s * 1e3, 3),
                            compute_ms=round(compute_s * 1e3, 3),
                            total_ms=round(total_s * 1e3, 3))
                if slow:
                    self._emit_slow_trace(t, queue_s, pad_s, compute_s,
                                          total_s, bucket)
            t.future.set_result(res)

    def _emit_slow_trace(self, t: Ticket, queue_s: float, pad_s: float,
                         compute_s: float, total_s: float,
                         bucket: int) -> None:
        """Retroactively emit the span timeline of one slow request:
        a ``serve:request`` root with ``queue``/``pad``/``compute``
        children, every span carrying the ticket's ``trace_id``.

        Spans can only be emitted retroactively here — at enqueue time
        nobody knows the request will be slow; that is the point of tail
        sampling. Wall-clock starts are back-dated from ``events.wall()``
        by the executor-clock durations, so the exported trace nests these
        under the same timeline as live spans (and the back-dating works
        under the tests' injected clocks too)."""
        wall_end = events.wall()
        pid = os.getpid()
        root_id = spans.next_span_id()
        root_start = wall_end - total_s

        def emit(name: str, span_id: int, parent_id: Optional[int],
                 depth: int, start: float, dur: float, **attrs) -> None:
            events.emit(
                "span", name, span_id=span_id, pid=pid,
                parent_id=parent_id,
                parent="serve:request" if parent_id else "",
                depth=depth, start=round(start, 6), dur_s=round(dur, 9),
                attrs={"trace_id": t.trace_id, **attrs})

        emit("serve:request", root_id, None, 0, root_start, total_s,
             model=t.model, rows=t.rows, bucket=bucket)
        emit("serve:queue", spans.next_span_id(), root_id, 1,
             root_start, queue_s)
        emit("serve:pad", spans.next_span_id(), root_id, 1,
             root_start + queue_s, pad_s)
        emit("serve:compute", spans.next_span_id(), root_id, 1,
             root_start + queue_s + pad_s, compute_s)

    # -- introspection -----------------------------------------------------
    @property
    def latency(self) -> metrics.Histogram:
        """THIS replica's total-latency histogram (the fleet scraper
        exports it as a per-replica labeled series)."""
        return self._latency

    def _lane_programs(self) -> List[tuple]:
        """``(model, draft, kind, bucket, program)`` of every program the
        generate lanes (and their drafts) have built."""
        out = []
        for name, lane in self._lanes.items():
            entries = [(False, lane.gen)]
            if lane.draft is not None:
                entries.append((True, lane.draft))
            for draft, gen in entries:
                for (kind, bucket), prog in gen.built_programs().items():
                    out.append((name, draft, kind, bucket, prog))
        return out

    def stats(self) -> Dict[str, float]:
        s = {"admitted": self._admitted.value,
             "shed": self._shed.value,
             "expired": self._expired.value,
             "completed": self._completed.value,
             "failed": self._failed.value,
             "inflight": self.inflight,
             "queue_depth": self._queue.qsize(),
             "pending_rows": self._batcher.pending_rows,
             "p50_ms": round(self._latency.percentile(50), 3),
             "p99_ms": round(self._latency.percentile(99), 3)}
        s.update({f"registry.{k}": v
                  for k, v in self.registry.stats().items()})
        for name, lane in self._lanes.items():
            s.update({f"generate.{name}.{k}": v
                      for k, v in lane.stats().items()})
        return s


def _device_report(programs: Sequence[tuple]) -> Dict[str, object]:
    """This process's kernel launch counts (``kernels/build.py``), each
    lane program's replays and the launches one replay makes (recorded at
    capture; an eager program records none), whether matmuls may use TF32,
    and the caching allocator's bytes on the current CUDA device (none on
    a machine without CUDA)."""
    import torch

    from mmlspark_tpu_torch.kernels import build as kbuild
    memory = {}
    if torch.cuda.is_available():
        memory = {"allocated": int(torch.cuda.memory_allocated()),
                  "max_allocated": int(torch.cuda.max_memory_allocated()),
                  "reserved": int(torch.cuda.memory_reserved())}
    return {
        "launches": {name: n for name, (n, _) in
                     kbuild.launch_counts().items()},
        "programs": [{"model": model, "draft": draft, "kind": kind,
                      "bucket": int(bucket), "replays": int(prog.replays),
                      "graph": hasattr(prog, "graph"),
                      "launches": {k: n for k, (n, _) in
                                   prog.launches.items()}}
                     for model, draft, kind, bucket, prog in programs],
        "tf32_matmul": bool(torch.backends.cuda.matmul.allow_tf32),
        "memory_bytes": memory,
    }
