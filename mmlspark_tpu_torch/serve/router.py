"""Fleet router: spread requests over N replicas, survive a dying one.

The port of ``mmlspark_tpu/serve/router.py``. The cross-replica layer the per-process primitives (bounded-queue shed,
``CircuitBreaker``, ``RetryPolicy``, drain) were built for. One
:class:`Router` fronts N replicas — anything satisfying the ``Replica``
protocol below: in-process :class:`~mmlspark_tpu_torch.serve.fleet.
InProcessReplica` handles or HTTP backends (:class:`HttpReplica`) — and gives callers ONE ``submit`` with fleet
semantics:

- **Weighted spread**: replicas are picked by smooth weighted round-robin
  (the nginx algorithm: deterministic, no RNG, interleaves weights
  evenly), over the READY set only. Weights are the rollout traffic
  lever — ``set_weight(name, 0.0)`` shifts a replica out of rotation
  without touching its in-flight work.
- **Health-checked**: every replica is probed through its ``health()``
  (the ``/healthz`` live/ready split) and guarded by a per-replica
  :class:`CircuitBreaker` — repeated submit failures trip it open, the
  single half-open probe slot re-admits it, and ``probe()`` (or the
  background prober) flips readiness the moment a replica reports
  draining, BEFORE it stops being alive.
- **Automatic failover**: a request in flight on a dying replica
  (``ReplicaUnavailable``, a connection error, a breaker trip) is retried
  on a different replica via ``RetryPolicy`` — same ``trace_id``, same
  absolute deadline (the remaining budget, not a fresh one); a replica
  already tried this request is excluded. ``fleet.failover_attempts``
  bounds the chain (default 2 = one failover).
- **Consolidated shed**: a replica shedding (``ServerOverloaded``) is not
  a failover — the router immediately offers the request to the next
  ready replica, and only when EVERY candidate shed does the caller see
  one consolidated ``ServerOverloaded`` whose ``retry_after`` is the
  MINIMUM across replicas (come back when the soonest frees up).
- **Per-tenant fairness**: admission runs through
  :class:`WeightedFairAdmission` — stride-scheduling virtual time plus a
  weighted in-flight quota over the fleet's summed capacity — so one hot
  tenant sheds (retryable ``TenantThrottled``) while everyone else keeps
  admitting. Layered ABOVE the per-replica bounded-queue shed path, not
  instead of it.

Every raw cross-replica call lives in this module, so nothing routes
around the breaker and retry wrappers.
"""
from __future__ import annotations

import threading
from email.utils import parsedate_to_datetime
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from mmlspark_tpu_torch.observability import events, metrics
from mmlspark_tpu_torch.reliability.breaker import CircuitBreaker, CircuitOpen
from mmlspark_tpu_torch.reliability.retry import RetryPolicy
from mmlspark_tpu_torch.serve.affinity import AffinityHint, AffinityState
from mmlspark_tpu_torch.serve.server import (
    RequestExpired, ServeError, ServerClosed, ServerOverloaded,
    _mint_trace_id, _Twin,
)
from mmlspark_tpu_torch.utils import config as mmlconfig
from mmlspark_tpu_torch.utils.logging import get_logger

logger = get_logger("serve.router")


class ReplicaUnavailable(ServeError):
    """The replica cannot take this request at the transport level — dead
    process, refused connection, torn socket. Retryable by contract: the
    router's failover policy sends the SAME request (same trace_id, same
    deadline) to a different replica."""
    retryable = True


class TenantThrottled(ServerOverloaded):
    """Admission rejected by the per-tenant fairness layer, not by any
    replica: this tenant is over its weighted share of fleet capacity
    while others still have headroom. Retryable (back off and resubmit),
    and deliberately a :class:`ServerOverloaded` subclass so existing
    shed handling (HTTP 503 mapping, retry classification) applies."""

    def __init__(self, tenant: str, inflight: int, share: int,
                 retry_after: Optional[float] = None):
        super().__init__(
            f"tenant {tenant!r} over fair share ({inflight} in flight, "
            f"share {share}); retry with backoff", retry_after=retry_after)
        self.tenant = tenant


class _AllShed(ServeError):
    """Internal: every candidate replica shed this request. NOT retryable
    — re-spinning the same saturated fleet immediately is how overload
    becomes an outage; the caller gets the consolidated overload and its
    own retry layer backs off."""
    retryable = False

    def __init__(self, sheds: List[Tuple[str, ServerOverloaded]]):
        super().__init__("all replicas shed")
        self.sheds = sheds


def _parse_retry_after(value: Optional[str]) -> Optional[float]:
    """``Retry-After`` header -> seconds (delta-seconds or HTTP-date form);
    None when absent or unparseable. Never raises: a malformed header must
    not turn a retryable 503 into a crash. (A copy of the reference's
    ``models/downloader.py::_parse_retry_after``.)"""
    if not value:
        return None
    try:
        return max(0.0, float(value))
    except ValueError:
        pass
    try:
        import datetime
        when = parsedate_to_datetime(value)
        now = datetime.datetime.now(datetime.timezone.utc)
        if when.tzinfo is None:
            when = when.replace(tzinfo=datetime.timezone.utc)
        return max(0.0, (when - now).total_seconds())
    except (TypeError, ValueError):
        return None


def parse_tenant_weights(text: str) -> Dict[str, float]:
    """``fleet.tenant_weights`` config ("gold=3,free=1") -> dict."""
    out: Dict[str, float] = {}
    for part in (text or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, val = part.partition("=")
        if not sep or not name.strip():
            raise ValueError(
                f"tenant weights: expected NAME=WEIGHT, got {part!r}")
        w = float(val)
        if w <= 0:
            raise ValueError(f"tenant {name!r}: weight must be > 0")
        out[name.strip()] = w
    return out


class WeightedFairAdmission:
    """Stride-scheduling fairness + weighted in-flight quotas per tenant.

    Two mechanisms, one invariant ("a hot tenant cannot starve the
    rest"):

    - **Quota** (the enforcement): a tenant may hold at most
      ``ceil(weight_share * capacity)`` rows in flight, where the share
      is computed over the tenants ACTIVE right now — an idle fleet lets
      one tenant use everything; contention shrinks everyone to their
      weighted share. Over-quota admits raise :class:`TenantThrottled`.
    - **Virtual time** (the observability): classic stride scheduling —
      each admitted row advances the tenant's virtual time by
      ``rows / weight`` — so ``stats()`` exposes exactly how far ahead
      of its fair share every tenant is running. The chaos harness and
      the report read it; operators tune weights from it.

    Pure logic under one lock; no threads, no clock.
    """

    def __init__(self, capacity_rows: int,
                 weights: Optional[Dict[str, float]] = None,
                 default_weight: Optional[float] = None):
        if capacity_rows < 1:
            raise ValueError(
                f"capacity_rows must be >= 1, got {capacity_rows}")
        self.capacity_rows = int(capacity_rows)
        # the configured quota before any autopilot tightening: relax
        # actions ramp capacity back toward this, never past it
        self.baseline_rows = int(capacity_rows)
        self.weights = dict(weights or {})
        self.default_weight = float(
            default_weight if default_weight is not None
            else mmlconfig.get("fleet.tenant_default_weight"))
        if self.default_weight <= 0:
            raise ValueError("default tenant weight must be > 0")
        self._lock = threading.Lock()
        self._inflight: Dict[str, int] = {}
        self._vtime: Dict[str, float] = {}
        self._throttled = metrics.counter("fleet.tenant_throttled")

    def weight(self, tenant: str) -> float:
        return float(self.weights.get(tenant, self.default_weight))

    def share(self, tenant: str) -> int:
        """This tenant's current in-flight quota in rows (>= 1)."""
        with self._lock:
            return self._share_locked(tenant)

    def _share_locked(self, tenant: str) -> int:
        active = set(k for k, v in self._inflight.items() if v > 0)
        active.add(tenant)
        total = sum(self.weight(t) for t in active)
        frac = self.weight(tenant) / total if total > 0 else 1.0
        return max(1, int(np.ceil(frac * self.capacity_rows)))

    def admit(self, tenant: str, rows: int) -> None:
        """Charge ``rows`` to ``tenant`` or raise :class:`TenantThrottled`.
        Callers MUST pair every successful admit with :meth:`release` (the
        router does, in a finally)."""
        with self._lock:
            held = self._inflight.get(tenant, 0)
            share = self._share_locked(tenant)
            if held + rows > share:
                self._throttled.inc()
                if events.recording_enabled():
                    events.emit("fleet", "tenant_throttled", tenant=tenant,
                                inflight=held, rows=rows, share=share)
                raise TenantThrottled(tenant, held, share,
                                      retry_after=float(
                                          mmlconfig.get(
                                              "serving.retry_after_s")))
            self._inflight[tenant] = held + rows
            self._vtime[tenant] = self._vtime.get(tenant, 0.0) \
                + rows / self.weight(tenant)

    def release(self, tenant: str, rows: int) -> None:
        with self._lock:
            held = self._inflight.get(tenant, 0)
            self._inflight[tenant] = max(0, held - rows)

    def set_capacity(self, capacity_rows: int) -> None:
        """Adaptive-admission actuator: resize the fleet
        quota all tenant shares are computed from. Tightening under burn
        turns blind per-replica sheds into ordered per-tenant throttles;
        relaxing ramps back toward :attr:`baseline_rows`. In-flight work
        is untouched — only future admits see the new shares."""
        cap = int(capacity_rows)
        if cap < 1:
            raise ValueError(f"capacity_rows must be >= 1, got {cap}")
        with self._lock:
            old = self.capacity_rows
            self.capacity_rows = cap
        if events.recording_enabled():
            events.emit("fleet", "capacity", capacity_rows=cap,
                        previous=old)

    def stats(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            base = min(self._vtime.values()) if self._vtime else 0.0
            return {t: {"inflight": self._inflight.get(t, 0),
                        "weight": self.weight(t),
                        "vtime_lead": round(self._vtime.get(t, 0.0) - base,
                                            4)}
                    for t in sorted(set(self._inflight) | set(self._vtime))}


class _Handle:
    """Router-side state for one replica: weight, readiness, breaker,
    smooth-WRR accumulator."""

    __slots__ = ("replica", "name", "weight", "current", "ready", "state",
                 "breaker", "routed", "inflight")

    def __init__(self, replica, breaker: CircuitBreaker):
        self.replica = replica
        self.name = replica.name
        self.weight = 1.0
        self.current = 0.0          # smooth-WRR accumulator
        self.ready = True           # until a probe says otherwise
        self.state = "unknown"
        self.breaker = breaker
        self.routed = metrics.Counter(f"fleet.routed.{self.name}")
        self.inflight = 0           # requests inside _call_replica now


class Router:
    """Health-checked weighted router over N ``Replica`` backends.

    The protocol a backend must satisfy (duck-typed)::

        name: str
        submit(model, x, deadline_ms=None, trace_id="") -> np.ndarray
        health() -> {"live": bool, "ready": bool, "state": str}
        capacity_rows: int          # admission bound (fairness sizing)

    ``clock``/``sleep`` are injectable so failover and deadline tests run
    without wall time; probes are driven either manually (:meth:`probe`)
    or by :meth:`start_prober`'s background thread.
    """

    def __init__(self, replicas: Sequence, *,
                 failover_attempts: Optional[int] = None,
                 failover_delay_s: Optional[float] = None,
                 capacity_rows: Optional[int] = None,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 breaker_failures: Optional[int] = None,
                 breaker_reset_s: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None,
                 sleep: Optional[Callable[[float], None]] = None):
        if not replicas:
            raise ValueError("router needs at least one replica")
        self.clock = clock if clock is not None else events.perf
        self._sleep = sleep
        self._lock = threading.Lock()
        self._handles: "Dict[str, _Handle]" = {}
        # kept so add_replica() builds breakers identical to these
        self._breaker_failures = breaker_failures
        self._breaker_reset_s = breaker_reset_s
        for r in replicas:
            if r.name in self._handles:
                raise ValueError(f"duplicate replica name {r.name!r}")
            breaker = CircuitBreaker(
                f"fleet.{r.name}", failure_threshold=breaker_failures,
                reset_timeout_s=breaker_reset_s, clock=self.clock)
            self._handles[r.name] = _Handle(r, breaker)
        attempts = int(failover_attempts if failover_attempts is not None
                       else mmlconfig.get("fleet.failover_attempts"))
        if attempts < 1:
            raise ValueError(f"failover_attempts must be >= 1, "
                             f"got {attempts}")
        delay = float(failover_delay_s if failover_delay_s is not None
                      else mmlconfig.get("fleet.failover_delay_s"))
        kwargs = {} if sleep is None else {"sleep": sleep}
        self.failover_policy = RetryPolicy(
            max_attempts=attempts, base_delay=delay, jitter=0.0,
            name="fleet.failover", clock=self.clock, **kwargs)
        if capacity_rows is None:
            capacity_rows = int(mmlconfig.get("fleet.capacity_rows"))
        if capacity_rows <= 0:
            capacity_rows = sum(
                int(getattr(h.replica, "capacity_rows", 0)) or 256
                for h in self._handles.values())
        if tenant_weights is None:
            tenant_weights = parse_tenant_weights(
                str(mmlconfig.get("fleet.tenant_weights")))
        self.fairness = WeightedFairAdmission(capacity_rows, tenant_weights)
        # per-instance twins (like Server's counters): stats() must read
        # THIS router's counts even when several routers share the
        # process-wide metrics registry (chaos runs two in a row)
        self._failovers = _Twin("fleet.failovers")
        self._all_shed = _Twin("fleet.all_shed")
        # prefix/session affinity for the generate lane (serve/affinity.py).
        # With no digests published
        # yet (no scraper) and no session keys, picks reduce to pure WRR.
        self.affinity: Optional[AffinityState] = (
            AffinityState()
            if bool(mmlconfig.get("fleet.affinity_enabled")) else None)
        self._prober: Optional[threading.Thread] = None
        self._prober_stop = threading.Event()
        # chaos sets this to a list: the router then appends the serving
        # replica's name per routed request — the deterministic schedule
        # two same-seed runs must reproduce bit-for-bit
        self.route_log: Optional[List[str]] = None

    # -- replica set -------------------------------------------------------
    def replica_names(self) -> List[str]:
        return sorted(self._handles)

    def add_replica(self, replica, *, weight: float = 1.0) -> None:
        """Scale-up actuator: put a new backend into
        rotation with its own fresh breaker, same knobs as the founding
        set. The next :meth:`_pick` can route to it immediately."""
        if weight < 0:
            raise ValueError(f"weight must be >= 0, got {weight}")
        with self._lock:
            if replica.name in self._handles:
                raise ValueError(
                    f"duplicate replica name {replica.name!r}")
            breaker = CircuitBreaker(
                f"fleet.{replica.name}",
                failure_threshold=self._breaker_failures,
                reset_timeout_s=self._breaker_reset_s, clock=self.clock)
            h = _Handle(replica, breaker)
            h.weight = float(weight)
            self._handles[replica.name] = h
        if events.recording_enabled():
            events.emit("fleet", "add_replica", replica=replica.name,
                        weight=weight)

    def remove_replica(self, name: str) -> None:
        """Scale-down actuator: take a backend out of the
        rotation entirely. In-flight work on it is untouched — callers
        drain the backend themselves (``Fleet.scale_down`` does)."""
        with self._lock:
            if name not in self._handles:
                raise KeyError(f"unknown replica {name!r}")
            if len(self._handles) == 1:
                raise ValueError(
                    "cannot remove the last replica from the router")
            del self._handles[name]
        if self.affinity is not None:
            self.affinity.forget(name)
        if events.recording_enabled():
            events.emit("fleet", "remove_replica", replica=name)

    def set_weight(self, name: str, weight: float) -> None:
        """Traffic share for one replica (0.0 = out of rotation — the
        rollout shift lever). In-flight work is untouched."""
        if weight < 0:
            raise ValueError(f"weight must be >= 0, got {weight}")
        with self._lock:
            h = self._handles[name]
            h.weight = float(weight)
            h.current = 0.0
        if events.recording_enabled():
            events.emit("fleet", "weight", replica=name, weight=weight)

    def reset_breaker(self, name: str) -> None:
        """Force-close one replica's breaker (operator/supervisor lever).
        A replica that was DOWN long enough to trip its breaker open and
        then came back healthy would otherwise wait out the full cooldown
        before taking traffic; the supervisor calls this on a verified
        warm restart so re-registration is immediate."""
        self._handles[name].breaker.reset()

    def _pick(self, exclude: frozenset,
              hint: Optional[AffinityHint] = None) -> Optional[_Handle]:
        """Smooth weighted round-robin over ready, positive-weight,
        non-excluded replicas. Deterministic: same weights + same call
        sequence = same spread (the chaos schedule depends on this).

        With an affinity ``hint``, the SAFE candidate set is first
        narrowed by :meth:`AffinityState.select` — session stickiness,
        then expected prefix-hit depth — and the WRR spread runs over
        the narrowed pool (the tie-break). The safety filter above is
        non-negotiable: affinity never resurrects an excluded, unready,
        or zero-weight replica, and on failover the survivors are
        re-scored with the dead replica in ``exclude``.

        Overload overrides affinity (bounded load): when every replica
        affinity picked is carrying more than
        ``fleet.affinity_spill_factor`` times the candidate-mean
        in-flight count (plus one — idle fleets never spill), the pick
        SPILLS back to the full WRR pool. A warm cache is never worth a
        hot spot, and a Zipf-heavy trace would otherwise convoy behind
        the one replica that owns the hottest chain."""
        mode, depth = "wrr", 0
        with self._lock:
            cands = [h for h in self._handles.values()
                     if h.ready and h.weight > 0 and h.name not in exclude]
        if not cands:
            return None
        pool = cands
        if hint is not None and self.affinity is not None:
            names, mode, depth = self.affinity.select(
                [h.name for h in cands], hint)
            chosen = [h for h in cands if h.name in set(names)]
            if chosen and mode != "wrr":
                factor = float(mmlconfig.get("fleet.affinity_spill_factor"))
                if factor > 0:
                    with self._lock:
                        cap = factor * (
                            sum(h.inflight for h in cands) / len(cands) + 1)
                        chosen = [h for h in chosen if h.inflight + 1 <= cap]
                        if not chosen:
                            # spill AWAY from the loaded leader, not back
                            # onto it: the cool replica that absorbs this
                            # miss caches the chain and advertises it —
                            # hot chains grow replicas under pressure
                            chosen = [h for h in cands
                                      if h.inflight + 1 <= cap]
                if not chosen:
                    chosen = cands
                    mode, depth = "wrr", 0
                elif mode != "wrr" and not set(names) & {
                        h.name for h in chosen}:
                    mode, depth = "wrr", 0
                if mode == "wrr":
                    self.affinity.observe_spill()
            if chosen:
                pool = chosen
        with self._lock:
            total = sum(h.weight for h in pool)
            for h in pool:
                h.current += h.weight
            best = max(pool, key=lambda h: (h.current, h.name))
            best.current -= total
        if hint is not None and self.affinity is not None:
            self.affinity.observe_route(best.name, mode, depth)
        return best

    # -- health ------------------------------------------------------------
    def probe(self) -> Dict[str, str]:
        """Probe every replica's ``health()`` once; flip readiness and
        feed the breakers (an unreachable replica counts a failure, a
        healthy answer counts a success so half-open closes). Returns
        ``{name: state}``. Deterministic given the replicas' answers —
        tests and the chaos harness drive this instead of the thread."""
        states: Dict[str, str] = {}
        for h in list(self._handles.values()):
            try:
                health = h.replica.health()
            except Exception as e:
                health = {"live": False, "ready": False, "state": "dead"}
                logger.warning("probe %s failed: %s", h.name, e)
            ready = bool(health.get("ready")) and bool(health.get("live"))
            state = str(health.get("state", "dead"))
            prev = h.state
            with self._lock:
                h.ready = ready
                h.state = state
            if ready:
                # a ready answer is the health probe succeeding: close a
                # tripped breaker through its half-open slot so traffic
                # returns without waiting for a live request to probe
                if h.breaker.state != "closed" and h.breaker.allow():
                    h.breaker.record_success()
            else:
                h.breaker.record_failure()
            if prev != state and events.recording_enabled():
                events.emit("fleet", "probe", replica=h.name, state=state,
                            prev=prev, ready=ready)
            states[h.name] = state
        if metrics.metrics_enabled():
            metrics.gauge("fleet.replicas_ready").set(
                sum(1 for h in self._handles.values() if h.ready))
        return states

    def start_prober(self, interval_s: Optional[float] = None) -> None:
        """Background health probing every ``fleet.probe_interval_s``."""
        if self._prober is not None:
            return
        poll = float(interval_s if interval_s is not None
                     else mmlconfig.get("fleet.probe_interval_s"))

        def run() -> None:
            while not self._prober_stop.wait(poll):
                try:
                    self.probe()
                except Exception as e:  # prober must outlive one bad round
                    logger.warning("prober round failed: %s", e)

        self._prober = threading.Thread(
            target=run, name="mmlspark-tpu-fleet-prober", daemon=True)
        self._prober.start()

    def stop_prober(self) -> None:
        if self._prober is None:
            return
        self._prober_stop.set()
        self._prober.join(timeout=5)
        self._prober = None
        self._prober_stop = threading.Event()

    # -- routing -----------------------------------------------------------
    def submit(self, model: str, x, deadline_ms: Optional[float] = None,
               *, tenant: str = "default",
               trace_id: Optional[str] = None) -> np.ndarray:
        """Route one request: fairness admit -> pick replica -> call
        through its breaker -> failover once (``RetryPolicy``) if the
        replica dies under it. The ``trace_id`` and absolute deadline
        survive the whole chain."""
        arr = np.asarray(x)
        rows = int(arr.shape[0]) if arr.ndim > 1 else 1
        trace_id = trace_id or _mint_trace_id()
        deadline = None
        if deadline_ms is not None and deadline_ms > 0:
            deadline = self.clock() + deadline_ms / 1e3
        self.fairness.admit(tenant, rows)

        def call(h: _Handle, remaining_ms: Optional[float]):
            return h.replica.submit(
                model, x, deadline_ms=remaining_ms, trace_id=trace_id)

        try:
            return self._route(model, call, trace_id, deadline)
        finally:
            self.fairness.release(tenant, rows)

    def submit_generate(self, model: str, prompt,
                        max_new_tokens: Optional[int] = None, *,
                        temperature: float = 0.0, top_k: int = 0,
                        seed: int = 0, eos_id: Optional[int] = None,
                        deadline_ms: Optional[float] = None,
                        tenant: str = "default",
                        session: Optional[str] = None,
                        trace_id: Optional[str] = None) -> Dict:
        """Route one generation request with fleet semantics. Failover is
        a RESTART: generation state (KV pages, sampled tokens) dies with
        the replica, so the surviving replica replays the whole request
        from its prompt — and because sampling is seeded per (seed,
        position), the replayed stream is token-identical. Same
        ``trace_id`` and the REMAINING deadline ride the retry.

        Routing is prefix-affine: the prompt's block-hash chain is scored against every
        READY replica's advertised digest, and a ``session`` key pins a
        multi-turn conversation to one replica via the consistent-hash
        ring — health, breakers, and overload always override both."""
        prompt = [int(t) for t in np.asarray(prompt).ravel()]
        trace_id = trace_id or _mint_trace_id()
        deadline = None
        if deadline_ms is not None and deadline_ms > 0:
            deadline = self.clock() + deadline_ms / 1e3
        hint = self.affinity.hint_for(model, prompt, session) \
            if self.affinity is not None else None
        self.fairness.admit(tenant, 1)

        def call(h: _Handle, remaining_ms: Optional[float]):
            return h.replica.submit_generate(
                model, prompt, max_new_tokens, temperature=temperature,
                top_k=top_k, seed=seed, eos_id=eos_id,
                deadline_ms=remaining_ms, trace_id=trace_id)

        try:
            return self._route(model, call, trace_id, deadline,
                               kind="generate", hint=hint)
        finally:
            self.fairness.release(tenant, 1)

    def _route(self, model: str, call: Callable, trace_id: str,
               deadline: Optional[float], kind: str = "score",
               hint: Optional[AffinityHint] = None):
        tried: set = set()
        sheds: List[Tuple[str, ServerOverloaded]] = []
        try:
            for attempt in self.failover_policy.attempts():
                with attempt:
                    return self._route_once(model, call, trace_id,
                                            deadline, tried, sheds, kind,
                                            hint)
        except _AllShed:
            pass  # consolidated below
        except (ReplicaUnavailable, CircuitOpen, ConnectionError) as e:
            if sheds:
                pass  # some replicas shed, the rest died: still overload
            else:
                raise ReplicaUnavailable(
                    f"no healthy replica for {model!r} "
                    f"(tried {sorted(tried)}): {e}") from e
        # every candidate shed: ONE consolidated overload whose
        # retry_after is the minimum ask across replicas
        self._all_shed.inc()
        afters = [e.retry_after for _, e in sheds
                  if getattr(e, "retry_after", None) is not None]
        retry_after = min(afters) if afters else None
        if events.recording_enabled():
            events.emit("fleet", "all_shed", model=model, trace_id=trace_id,
                        replicas=[n for n, _ in sheds],
                        retry_after=retry_after)
        raise ServerOverloaded(
            f"all {len(sheds)} replica(s) shedding "
            f"({', '.join(n for n, _ in sheds) or 'none ready'}); "
            "retry with backoff", retry_after=retry_after) from None

    def _route_once(self, model: str, call: Callable, trace_id: str,
                    deadline: Optional[float], tried: set,
                    sheds: List[Tuple[str, ServerOverloaded]],
                    kind: str = "score",
                    hint: Optional[AffinityHint] = None):
        """One routing attempt: offer the request to ready replicas in WRR
        order. A shed moves on to the next candidate in THIS attempt; a
        dead replica raises so the failover policy retries (a fresh
        attempt, this replica excluded — and, with an affinity hint, the
        survivors re-scored by prefix depth so the warmest one wins the
        restart). ``call(handle, remaining_ms)`` performs the actual
        replica call — scoring and generation share this whole
        routing/failover/shed machinery."""
        while True:
            if deadline is not None and self.clock() >= deadline:
                raise RequestExpired(
                    f"deadline passed before a replica could answer "
                    f"(tried {sorted(tried)})")
            h = self._pick(frozenset(tried), hint)
            if h is None:
                if sheds:
                    raise _AllShed(sheds)
                raise ReplicaUnavailable(
                    f"no ready replica (of {len(self._handles)}) for "
                    f"{model!r}; tried {sorted(tried)}")
            remaining_ms = None
            if deadline is not None:
                remaining_ms = max((deadline - self.clock()) * 1e3, 0.001)
            with self._lock:
                h.inflight += 1     # the spill bound reads this
            try:
                out = self._call_replica(h, call, remaining_ms)
            except ServerOverloaded as e:
                # this replica is full/draining, not dead: same attempt,
                # next candidate (don't charge the failover budget)
                tried.add(h.name)
                sheds.append((h.name, e))
                continue
            except RequestExpired:
                raise  # the caller's deadline elapsed; retrying is futile
            except (KeyError, ValueError, TypeError):
                raise  # client error: same everywhere, don't failover
            except ServerClosed as e:
                self._mark_down(h, "closed")
                self._emit_failover(h, trace_id, e, kind)
                tried.add(h.name)
                raise ReplicaUnavailable(
                    f"replica {h.name} closed mid-request") from e
            except (ReplicaUnavailable, CircuitOpen, ConnectionError,
                    OSError) as e:
                # dying replica: mark it down, let the RetryPolicy give
                # this request its one failover on a healthy one
                self._mark_down(h, "dead")
                self._emit_failover(h, trace_id, e, kind)
                tried.add(h.name)
                raise
            finally:
                with self._lock:
                    h.inflight -= 1
            h.routed.inc()
            if self.route_log is not None:
                self.route_log.append(h.name)
            return out

    @staticmethod
    def _call_replica(h: _Handle, call: Callable,
                      remaining_ms: Optional[float]):
        """One raw replica call through its breaker. A replica that
        ANSWERS — even with a shed, an expired deadline, or a client
        error — is alive, so only transport-level failures feed the
        breaker's failure count; application answers record success."""
        answered: List[BaseException] = []

        def guarded():
            try:
                return call(h, remaining_ms)
            except (ServerOverloaded, RequestExpired, KeyError, ValueError,
                    TypeError) as e:
                answered.append(e)
                return None

        out = h.breaker.call(guarded)
        if answered:
            raise answered[0]
        return out

    def _mark_down(self, h: _Handle, state: str) -> None:
        with self._lock:
            h.ready = False
            h.state = state

    def _emit_failover(self, h: _Handle, trace_id: str,
                       exc: BaseException, kind: str = "score") -> None:
        self._failovers.inc()
        logger.warning("failover off %s (%s: %s)", h.name,
                       type(exc).__name__, exc)
        if events.recording_enabled():
            events.emit("fleet", "failover", replica=h.name,
                        trace_id=trace_id, kind=kind,
                        error=f"{type(exc).__name__}: {exc}")

    # -- Server-compatible surface (the HTTP front-end binds either) -------
    def submit_async(self, model: str, x,
                     deadline_ms: Optional[float] = None, *,
                     trace_id: Optional[str] = None):
        """Server-API shim for :func:`~mmlspark_tpu_torch.serve.http.
        make_handler`: routes synchronously in the calling thread (HTTP
        connection threads already block on their reply) and returns a
        resolved Future carrying ``trace_id``."""
        from concurrent.futures import Future
        fut: Future = Future()
        tid = trace_id or _mint_trace_id()
        fut.trace_id = tid
        # routing errors propagate synchronously, matching Server's
        # submit_async admission semantics (the front-end maps them)
        fut.set_result(self.submit(model, x, deadline_ms, trace_id=tid))
        return fut

    def submit_many(self, model: str, x,
                    deadline_ms: Optional[float] = None,
                    timeout: Optional[float] = None) -> np.ndarray:
        arr = np.asarray(x)
        if arr.ndim == 1:
            arr = arr[None, :]
        bs = int(mmlconfig.get("serving.max_batch"))
        outs = [self.submit(model, arr[i:i + bs], deadline_ms)
                for i in range(0, arr.shape[0], bs)]
        return np.concatenate(outs, axis=0)

    @property
    def draining(self) -> bool:
        return all(h.state == "draining" for h in self._handles.values())

    def health(self) -> Dict[str, object]:
        """Fleet-level health: live while ANY replica is live, ready
        while ANY replica is ready."""
        with self._lock:
            ready = any(h.ready for h in self._handles.values())
            states = {h.name: h.state for h in self._handles.values()}
        live = ready or any(s in ("draining", "unknown")
                            for s in states.values())
        state = "ready" if ready else (
            "draining" if live else "closed")
        return {"live": live, "ready": ready, "state": state,
                "replicas": states}

    @property
    def registry(self) -> "_FleetRegistryView":
        return _FleetRegistryView(self)

    def stats(self) -> Dict[str, object]:
        with self._lock:
            per = {h.name: {"weight": h.weight, "ready": h.ready,
                            "state": h.state, "routed": h.routed.value,
                            "breaker": h.breaker.state}
                   for h in self._handles.values()}
        out = {"replicas": per,
               "failovers": self._failovers.value,
               "all_shed": self._all_shed.value,
               "tenants": self.fairness.stats()}
        if self.affinity is not None:
            out["affinity"] = self.affinity.stats()
        return out

    def close(self) -> None:
        self.stop_prober()


class _FleetRegistryView:
    """Just enough registry surface for the HTTP front-end (`/models`):
    the first answering replica's model list (replicas serve the same
    set; during a rollout versions may transiently differ per replica)."""

    def __init__(self, router: Router):
        self._router = router

    def names(self) -> List[str]:
        for h in self._router._handles.values():
            try:
                return sorted(h.replica.models())
            except Exception:
                continue
        return []


class HttpReplica:
    """A remote serving process (a :class:`Server` behind
    :func:`~mmlspark_tpu_torch.serve.http.serve_http`) behind the Replica
    protocol: scores over ``POST /score``, generation over
    ``POST /generate`` (the reference's HttpReplica scores only; the port's
    process fleet also generates), health over
    ``GET /healthz``. Transport failures raise
    :class:`ReplicaUnavailable`; HTTP status mapping mirrors the
    front-end's (503 -> :class:`ServerOverloaded` with the parsed
    ``Retry-After``, 504 -> :class:`RequestExpired`, 400 ->
    ``ValueError``)."""

    def __init__(self, addr: str, name: Optional[str] = None,
                 timeout_s: Optional[float] = None,
                 capacity_rows: int = 256):
        self.addr = addr.rstrip("/")
        if "://" not in self.addr:
            self.addr = "http://" + self.addr
        self.name = name or addr
        self.timeout_s = float(
            timeout_s if timeout_s is not None
            else mmlconfig.get("reliability.http_timeout"))
        self.capacity_rows = int(capacity_rows)

    def submit(self, model: str, x, deadline_ms: Optional[float] = None,
               trace_id: str = "") -> np.ndarray:
        body = {"model": model, "x": np.asarray(x).tolist()}
        if deadline_ms is not None:
            body["deadline_ms"] = deadline_ms
        if trace_id:
            body["trace_id"] = trace_id
        payload = self._post("/score", body, deadline_ms)
        return np.asarray(payload["y"], np.float32)

    def submit_generate(self, model: str, prompt,
                        max_new_tokens: Optional[int] = None, *,
                        temperature: float = 0.0, top_k: int = 0,
                        seed: int = 0, eos_id: Optional[int] = None,
                        deadline_ms: Optional[float] = None,
                        trace_id: str = "") -> Dict:
        """``POST /generate``: the remote lane's result dict (``tokens``,
        ``finish_reason``, ``ttft_ms``, ...). The request waits for the
        whole generation, so only a deadline bounds it below
        ``reliability.http_timeout``."""
        body = {"model": model,
                "prompt": [int(t) for t in np.asarray(prompt).ravel()],
                "max_new_tokens": max_new_tokens,
                "temperature": float(temperature), "top_k": int(top_k),
                "seed": int(seed), "eos_id": eos_id}
        if deadline_ms is not None:
            body["deadline_ms"] = deadline_ms
        if trace_id:
            body["trace_id"] = trace_id
        return self._post("/generate", body, deadline_ms)

    def _post(self, endpoint: str, body: Dict,
              deadline_ms: Optional[float]) -> Dict:
        import json as _json
        import urllib.error
        import urllib.request
        req = urllib.request.Request(
            f"{self.addr}{endpoint}", data=_json.dumps(body).encode("utf-8"),
            headers={"Content-Type": "application/json"})
        timeout = self.timeout_s
        if deadline_ms is not None:
            timeout = min(timeout, max(deadline_ms / 1e3, 0.001) + 1.0)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                payload = _json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            detail = self._error_detail(e)
            if e.code == 503:
                raise ServerOverloaded(
                    f"replica {self.name} shed: {detail}",
                    retry_after=_parse_retry_after(
                        e.headers.get("Retry-After"))) from None
            if e.code == 504:
                raise RequestExpired(
                    f"replica {self.name}: {detail}") from None
            if e.code == 400:
                raise ValueError(
                    f"replica {self.name}: {detail}") from None
            raise ReplicaUnavailable(
                f"replica {self.name} HTTP {e.code}: {detail}") from None
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            raise ReplicaUnavailable(
                f"replica {self.name} unreachable: {e}") from None
        return payload

    @staticmethod
    def _error_detail(e) -> str:
        import json as _json
        try:
            return str(_json.loads(e.read().decode("utf-8")).get(
                "error", ""))
        except Exception:
            return str(e)

    def health(self) -> Dict[str, object]:
        import json as _json
        import urllib.error
        import urllib.request
        try:
            with urllib.request.urlopen(
                    f"{self.addr}/healthz", timeout=self.timeout_s) as resp:
                body = _json.loads(resp.read().decode("utf-8"))
        except (urllib.error.URLError, OSError, ValueError,
                TimeoutError) as e:
            logger.debug("healthz %s unreachable: %s", self.name, e)
            return {"live": False, "ready": False, "state": "dead"}
        # pre-split servers answered {"status": "ok"|"draining"} only
        state = str(body.get("state")
                    or ("ready" if body.get("status") == "ok"
                        else body.get("status", "dead")))
        return {"live": bool(body.get("live", state != "closed")),
                "ready": bool(body.get("ready", state == "ready")),
                "state": state}

    def models(self) -> List[str]:
        import json as _json
        import urllib.error
        import urllib.request
        try:
            with urllib.request.urlopen(
                    f"{self.addr}/models", timeout=self.timeout_s) as resp:
                return list(
                    _json.loads(resp.read().decode("utf-8"))["models"])
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            raise ReplicaUnavailable(
                f"replica {self.name} unreachable: {e}") from None

    def _probe(self, endpoint: str) -> bool:
        """GET a liveness-style endpoint with the replica timeout. 200 is
        True, a 503 answer is False (the endpoint's not-yet contract), and
        a transport failure — connection refused mid-restart, torn socket,
        timeout — raises retryable :class:`ReplicaUnavailable` instead of
        leaking a raw ``URLError`` into the prober thread."""
        import urllib.error
        import urllib.request
        try:
            with urllib.request.urlopen(
                    f"{self.addr}{endpoint}", timeout=self.timeout_s):
                return True
        except urllib.error.HTTPError as e:
            if e.code == 503:
                return False
            raise ReplicaUnavailable(
                f"replica {self.name} {endpoint} HTTP {e.code}") from None
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            raise ReplicaUnavailable(
                f"replica {self.name} unreachable on {endpoint}: {e}"
            ) from None

    def probe_livez(self) -> bool:
        """Remote ``/livez``: True iff the process answers 200."""
        return self._probe("/livez")

    def probe_readyz(self) -> bool:
        """Remote ``/readyz``: True iff the replica is admitting traffic
        (a draining or warming replica answers 503 -> False)."""
        return self._probe("/readyz")
