"""Seeded, virtual-time, OPEN-LOOP workload generation.

The port's copy of ``mmlspark_tpu/testing/loadgen.py`` (pure Python and
numpy: the same seed and trace give the same schedule and fingerprint).

The bench and chaos drivers used to be closed loops: every client waited
for its previous reply before offering the next request, so the moment
the fleet wedged, the offered load politely stopped — and the recorded
latency stopped with it. That is the coordinated-omission failure mode
(Tene, "How NOT to Measure Latency"; Schroeder et al., "Open Versus
Closed: A Cautionary Tale", NSDI'06): the p99 of a stalled system looks
*better* because the stall suppressed the samples that would have shown
it.

This module is the other half of the fix (the measurement half lives in
:mod:`mmlspark_tpu_torch.observability.goodput`): a workload is a pure,
seeded function ``(seed, Trace) -> [Arrival, ...]`` — every request's
INTENDED arrival time decided before the system under test runs, so the
driver can always answer "when should this have arrived?" no matter how
the system behaves. Properties:

- **Arrival processes** — ``poisson`` (non-homogeneous, Lewis–Shedler
  thinning against the trace's rate curve) and ``pareto`` (heavy-tailed
  inter-arrival gaps, the bursty regime a memoryless process smooths
  away).
- **Trace shapes** — ``constant``, ``diurnal`` (sinusoidal rate swing),
  and ``spike`` (flash crowd: ``rate * spike_factor`` inside a window).
- **Tenant mixes** and open-loop **multi-turn sessions**: a session's
  turn ``k`` is scheduled at ``t0 + k * think_s`` from the session's
  own intent, never from the previous reply.
- **Shared-prefix prompt populations** (:class:`PromptPopulation`):
  Zipf-weighted prefix reuse for the decode lanes.
- **Zipf-hot recommender payloads** (:func:`zipf_ids`,
  :func:`recommender_rows`): packed ``[dense | ids]`` scoring rows with
  the hot-user/hot-item skew the embedding lanes serve under.
- **Virtual time** — schedules are data; :class:`EventQueue` and the
  two reference simulators walk them in virtual time, so ~10^5–10^6
  virtual users cost heap events, not threads, and compose with the
  injectable clocks of the supervisor, the SLO engine and the autopilot.
- **Byte-identical replay** — same ``(seed, trace)`` -> the same
  schedule, asserted via :func:`schedule_fingerprint` (sha256 over the
  canonical serialization).

Load is built only through this vocabulary, so a schedule is always
replayable from its seed.
"""
from __future__ import annotations

import hashlib
import heapq
import math
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Arrival", "Trace", "rate_at", "peak_rate", "generate",
    "schedule_fingerprint", "bucket_counts", "feature_rows",
    "token_prompts", "zipf_ids", "recommender_rows",
    "PromptPopulation", "EventQueue",
    "simulate_open_loop", "simulate_closed_loop", "run_open_loop",
]


@dataclass(frozen=True, order=True)
class Arrival:
    """One intended request: WHEN it should arrive, decided up front."""
    t: float                 # intended arrival time, seconds from trace t0
    index: int               # position in schedule order (ties broken here)
    tenant: str = "default"
    session: str = ""        # session id when the trace is multi-turn
    turn: int = 0            # 0-based turn within the session

    @property
    def trace_id(self) -> str:
        if self.session:
            return f"{self.session}.t{self.turn}"
        return f"q{self.index:06d}"


@dataclass(frozen=True)
class Trace:
    """The declarative workload spec — everything but the seed.

    ``rate`` is the base arrivals/second; the shape modulates it over
    ``duration_s``. ``session_turns > 1`` turns each first arrival into
    a session whose later turns land ``think_s`` apart (open-loop).
    """
    duration_s: float
    rate: float
    shape: str = "constant"           # constant | diurnal | spike
    process: str = "poisson"          # poisson | pareto
    spike_start_s: float = 0.0
    spike_len_s: float = 0.0
    spike_factor: float = 1.0
    diurnal_period_s: float = 0.0     # 0 -> one full period over the trace
    diurnal_amplitude: float = 0.5    # fraction of rate swung by the sine
    pareto_alpha: float = 1.5         # tail shape; mean requires alpha > 1
    tenants: Tuple[Tuple[str, float], ...] = (("default", 1.0),)
    session_turns: int = 1            # max turns per session (uniform draw)
    think_s: float = 0.0              # inter-turn gap for sessions

    def describe(self) -> Dict[str, Any]:
        d = {"duration_s": self.duration_s, "rate": self.rate,
             "shape": self.shape, "process": self.process,
             "tenants": dict(self.tenants)}
        if self.shape == "spike":
            d.update(spike_start_s=self.spike_start_s,
                     spike_len_s=self.spike_len_s,
                     spike_factor=self.spike_factor)
        if self.shape == "diurnal":
            d.update(diurnal_period_s=self.diurnal_period_s or
                     self.duration_s,
                     diurnal_amplitude=self.diurnal_amplitude)
        if self.process == "pareto":
            d["pareto_alpha"] = self.pareto_alpha
        if self.session_turns > 1:
            d.update(session_turns=self.session_turns,
                     think_s=self.think_s)
        return d


def rate_at(trace: Trace, t: float) -> float:
    """Instantaneous offered rate (arrivals/s) at trace time ``t``."""
    if trace.shape == "spike":
        if trace.spike_start_s <= t < trace.spike_start_s + trace.spike_len_s:
            return trace.rate * trace.spike_factor
        return trace.rate
    if trace.shape == "diurnal":
        period = trace.diurnal_period_s or trace.duration_s
        swing = math.sin(2.0 * math.pi * t / max(period, 1e-9))
        return max(0.0, trace.rate * (1.0 + trace.diurnal_amplitude * swing))
    if trace.shape == "constant":
        return trace.rate
    raise ValueError(f"unknown trace shape {trace.shape!r}")


def peak_rate(trace: Trace) -> float:
    """Upper bound of the rate curve — the thinning envelope."""
    if trace.shape == "spike":
        return trace.rate * max(1.0, trace.spike_factor)
    if trace.shape == "diurnal":
        return trace.rate * (1.0 + max(0.0, trace.diurnal_amplitude))
    return trace.rate


def _arrival_times(trace: Trace, rng: random.Random) -> List[float]:
    """First-turn arrival times over ``[0, duration_s)``.

    ``poisson``: Lewis–Shedler thinning — candidates from a homogeneous
    process at the peak rate, kept with probability ``rate_at/peak``.
    ``pareto``: heavy-tailed gaps scaled so the LOCAL mean inter-arrival
    matches ``1/rate_at`` (bursts plus long silences at the same average
    load a Poisson trace offers).
    """
    lam = peak_rate(trace)
    if lam <= 0:
        return []
    out: List[float] = []
    t = 0.0
    if trace.process == "poisson":
        while True:
            t += rng.expovariate(lam)
            if t >= trace.duration_s:
                break
            if rng.random() * lam <= rate_at(trace, t):
                out.append(t)
    elif trace.process == "pareto":
        alpha = trace.pareto_alpha
        if alpha <= 1.0:
            raise ValueError("pareto_alpha must be > 1 (finite mean gap)")
        mean = alpha / (alpha - 1.0)
        while True:
            local = rate_at(trace, t)
            gap = (rng.paretovariate(alpha) / mean) / max(local, 1e-9)
            t += gap
            if t >= trace.duration_s:
                break
            out.append(t)
    else:
        raise ValueError(f"unknown arrival process {trace.process!r}")
    return out


def _pick_tenant(tenants: Sequence[Tuple[str, float]],
                 rng: random.Random) -> str:
    total = sum(w for _, w in tenants)
    x = rng.random() * total
    acc = 0.0
    for name, w in tenants:
        acc += w
        if x < acc:
            return name
    return tenants[-1][0]


def generate(trace: Trace, seed: int) -> List[Arrival]:
    """The whole point: ``(seed, trace) -> schedule``, byte-identical on
    replay. Arrivals come back time-sorted with ``index`` equal to their
    position; a multi-turn trace interleaves sessions' later turns into
    the same timeline (heap merge — the event queue, not per-user
    threads)."""
    rng = random.Random(seed)
    firsts = _arrival_times(trace, rng)
    heap: List[Tuple[float, int, int, str, str]] = []
    for i, t in enumerate(firsts):
        tenant = _pick_tenant(trace.tenants, rng)
        if trace.session_turns > 1:
            sess = f"s{i:05d}"
            turns = rng.randint(1, trace.session_turns)
            for k in range(turns):
                heapq.heappush(
                    heap, (t + k * trace.think_s, i, k, tenant, sess))
        else:
            heapq.heappush(heap, (t, i, 0, tenant, ""))
    out: List[Arrival] = []
    while heap:
        t, _, turn, tenant, sess = heapq.heappop(heap)
        out.append(Arrival(t=t, index=len(out), tenant=tenant,
                           session=sess, turn=turn))
    return out


def schedule_fingerprint(schedule: Sequence[Arrival]) -> str:
    """sha256 over the canonical serialization — two schedules with the
    same fingerprint ARE the same schedule (the replay contract the
    bench asserts)."""
    h = hashlib.sha256()
    for a in schedule:
        h.update(f"{a.t:.9f}|{a.index}|{a.tenant}|{a.session}|{a.turn}\n"
                 .encode())
    return h.hexdigest()


def bucket_counts(schedule: Sequence[Arrival], bucket_s: float,
                  min_buckets: int = 0) -> List[int]:
    """Arrivals per ``bucket_s`` window of intended time — the per-round
    offered load the virtual-round drivers consume."""
    if bucket_s <= 0:
        raise ValueError("bucket_s must be positive")
    n = min_buckets
    if schedule:
        n = max(n, int(schedule[-1].t / bucket_s) + 1)
    counts = [0] * n
    for a in schedule:
        counts[int(a.t / bucket_s)] += 1
    return counts


# -- payload populations -----------------------------------------------------

def feature_rows(n: int, rows: int, dim: int, seed: int) -> List[Any]:
    """The scoring lanes' request payloads: ``n`` float32 arrays of shape
    ``(rows, dim)`` from one seeded generator — the single construction
    every chaos/bench scoring stream shares."""
    import numpy as np
    xrng = np.random.default_rng(seed)
    return [xrng.normal(0, 1, (rows, dim)).astype(np.float32)
            for _ in range(n)]


def zipf_ids(n: int, *, rows: int, seed: int,
             zipf_s: float = 1.1) -> Any:
    """``n`` embedding-row ids in ``[1, rows)`` with Zipf-weighted
    popularity (id 1 hottest) — the skew real recommender traffic has,
    where a few hot users/items dominate every lookup batch. Returns an
    int32 numpy array; id 0 (the pad row, ``embed.tables.PAD_ID``) is
    never drawn. Same ``(seed, rows, zipf_s)`` -> the same id stream."""
    import numpy as np
    if rows < 2:
        raise ValueError("rows must be >= 2 (id 0 is the reserved pad)")
    ranks = np.arange(1, rows, dtype=np.float64)
    w = 1.0 / ranks ** zipf_s
    rng = np.random.default_rng(seed)
    ids = rng.choice(np.arange(1, rows, dtype=np.int64), size=n,
                     p=w / w.sum())
    return ids.astype(np.int32)


def recommender_rows(n: int, *, dense: int,
                     tables: Sequence[Tuple[int, int]], seed: int,
                     zipf_s: float = 1.1) -> Any:
    """``n`` packed recommender scoring rows — float32
    ``[dense features | slots ids per table]``, the ``embed.model`` wire
    format — with Zipf-hot ids per sparse feature. ``tables`` is
    ``((rows, slots), ...)`` in slot order; ids are exact in float32 up
    to 2^24. One seeded construction shared by the bench serve phase and
    the chaos recommender scenario."""
    import numpy as np
    rng = np.random.default_rng(seed)
    cols = [rng.normal(0.0, 1.0, (n, dense)).astype(np.float32)]
    for j, (rows, slots) in enumerate(tables):
        ids = zipf_ids(n * slots, rows=rows, seed=seed + 1000 * (j + 1),
                       zipf_s=zipf_s)
        cols.append(ids.reshape(n, slots).astype(np.float32))
    return np.concatenate(cols, axis=1)


def token_prompts(n: int, rng: random.Random, *, vocab: int = 200,
                  min_len: int = 3, max_len: int = 8) -> List[List[int]]:
    """Independent token prompts for the decode lanes (uniform vocab,
    uniform length). Takes the caller's ``random.Random`` so a scenario's
    downstream draws stay on its seeded stream."""
    return [[rng.randrange(1, vocab) for _ in range(rng.randint(min_len,
                                                                max_len))]
            for _ in range(n)]


class PromptPopulation:
    """Zipf-weighted shared-prefix prompt population.

    ``prefixes`` system prompts of ``prefix_tokens`` tokens each;
    :meth:`sample` picks one by Zipf rank (rank 0 hottest) and appends a
    fresh uniform tail — the reuse pattern that makes prefix caches
    earn their keep."""

    def __init__(self, rng: random.Random, *, prefixes: int = 1,
                 prefix_tokens: int = 8, vocab: int = 200,
                 zipf_s: float = 1.1):
        self.vocab = vocab
        self._rng = rng
        self._prefixes = [[rng.randrange(1, vocab)
                           for _ in range(prefix_tokens)]
                          for _ in range(prefixes)]
        weights = [1.0 / (k + 1) ** zipf_s for k in range(prefixes)]
        total = sum(weights)
        self._cum = []
        acc = 0.0
        for w in weights:
            acc += w / total
            self._cum.append(acc)

    def prefix(self, rank: int) -> List[int]:
        return list(self._prefixes[rank])

    def sample(self, *, tail_tokens: int = 2) -> List[int]:
        x = self._rng.random()
        rank = next((i for i, c in enumerate(self._cum) if x < c),
                    len(self._cum) - 1)
        return self.prefix(rank) + [self._rng.randrange(1, self.vocab)
                                    for _ in range(tail_tokens)]


# -- virtual-time drivers ----------------------------------------------------

class EventQueue:
    """Deterministic virtual-time event loop: push ``(t, fn)``, pop in
    time order (FIFO among equal times), the clock jumping event to
    event. This is what lets a million virtual users cost a million heap
    entries instead of a million threads."""

    def __init__(self, t0: float = 0.0):
        self.now = float(t0)
        self._seq = 0
        self._heap: List[Tuple[float, int, Callable[[float], Any]]] = []

    def push(self, t: float, fn: Callable[[float], Any]) -> None:
        heapq.heappush(self._heap, (max(float(t), self.now), self._seq, fn))
        self._seq += 1

    def __len__(self) -> int:
        return len(self._heap)

    def run(self, until: Optional[float] = None) -> int:
        """Dispatch events in time order; returns how many ran."""
        ran = 0
        while self._heap:
            if until is not None and self._heap[0][0] > until:
                break
            t, _, fn = heapq.heappop(self._heap)
            self.now = t
            fn(t)
            ran += 1
        return ran


def _skip_stalls(t: float, stalls: Sequence[Tuple[float, float]]) -> float:
    for s0, s1 in stalls:
        if s0 <= t < s1:
            t = s1
    return t


def simulate_open_loop(schedule: Sequence[Arrival], service_s: float, *,
                       stalls: Sequence[Tuple[float, float]] = (),
                       ) -> List[Dict[str, float]]:
    """Reference single-FIFO-server simulation, OPEN loop: every arrival
    joins the queue at its intended time regardless of what the server
    is doing; ``stalls`` are windows where the server makes no progress.
    Latency is measured from the INTENDED arrival — the honest number.
    """
    q = EventQueue()
    free = {"t": 0.0}
    out: List[Dict[str, float]] = []

    def _arrive(a: Arrival):
        def run(_t: float) -> None:
            start = _skip_stalls(max(a.t, free["t"]), stalls)
            done = start + service_s
            free["t"] = done
            out.append({"trace_id": a.trace_id, "arrival_t": a.t,
                        "start_t": start, "done_t": done,
                        "latency_s": done - a.t})
        return run

    for a in schedule:
        q.push(a.t, _arrive(a))
    q.run()
    return out


def simulate_closed_loop(schedule: Sequence[Arrival], service_s: float, *,
                         stalls: Sequence[Tuple[float, float]] = (),
                         clients: int = 1) -> List[Dict[str, float]]:
    """The SAME schedule through ``clients`` closed-loop clients: a
    client sends its next request only after its previous reply, and
    latency is measured from the throttled SEND time. This is the
    coordinated-omission-blind measurement the old drivers made — kept
    as a reference so tests can show exactly what it hides."""
    free = {"t": 0.0}
    client_free = [0.0] * max(1, clients)
    out: List[Dict[str, float]] = []
    for i, a in enumerate(schedule):
        c = i % len(client_free)
        send = max(a.t, client_free[c])        # the omission: send waits
        start = _skip_stalls(max(send, free["t"]), stalls)
        done = start + service_s
        free["t"] = done
        client_free[c] = done
        out.append({"trace_id": a.trace_id, "arrival_t": a.t,
                    "send_t": send, "done_t": done,
                    "latency_s": done - send})
    return out


def run_open_loop(schedule: Sequence[Arrival],
                  submit: Callable[[Arrival], Any], *,
                  clock: Optional[Callable[[], float]] = None,
                  sleep: Optional[Callable[[float], None]] = None) -> float:
    """Walk a schedule in WALL time: sleep until each intended arrival,
    then call ``submit(arrival)`` — never gated on replies, so a stalled
    system keeps receiving (and keeps being measured). ``submit`` should
    be non-blocking (e.g. ``Server.submit_async``); a blocking transport
    degrades to wrk2-style pacing, which stays honest as long as latency
    is measured from ``t0 + arrival.t``. Returns ``t0``."""
    import time as _time
    clock = clock or _time.perf_counter
    sleep = sleep or _time.sleep
    t0 = clock()
    for a in schedule:
        delay = (t0 + a.t) - clock()
        if delay > 0:
            sleep(delay)
        submit(a)
    return t0
