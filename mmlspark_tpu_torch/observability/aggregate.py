"""Fleet-wide metrics aggregation: one labeled view over N replicas.

The port of ``mmlspark_tpu/observability/aggregate.py``. Telemetry stops at the process boundary — every replica exposes
its own ``/metrics``, event logs are per-pid sidecars, and the process
registry has no labels (in-process fleet replicas all add into the SAME
counters). This module builds the fleet view:

- :class:`FleetScraper` pulls readiness + stats from every replica —
  in-process replicas through ``Server.stats()``/``health()`` (their
  per-instance twins ARE the per-replica series; the shared process
  registry cannot be), ``HttpReplica`` targets through ``GET /metrics``
  (Prometheus text, parsed) and ``GET /readyz`` — each target behind its
  own :class:`~mmlspark_tpu_torch.reliability.breaker.CircuitBreaker` so a
  hung replica cannot stall the scrape loop, with an injectable clock so
  tests drive breaker cooldowns deterministically; each scrape also
  publishes the replicas' prefix digests into the router's
  :class:`~mmlspark_tpu_torch.serve.affinity.AffinityState`, the only
  way prefix affinity is fed;
- :class:`AggregatedRegistry` holds the merged result: every series
  carries a ``replica="r0"`` label (plus ``model``/``kind`` for the
  device-memory ledger) and exports as one Prometheus exposition or a
  JSON dump;
- :func:`merge_event_logs` merges multi-process JSONL event logs
  (per-pid sidecars) into one ts-ordered stream.

:meth:`FleetScraper.slo_sample` distills a scrape into the cumulative
totals an SLO engine windows over (the engine itself is a later slice).
"""
from __future__ import annotations

import glob as _glob
import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from mmlspark_tpu_torch.observability import events, metrics
from mmlspark_tpu_torch.observability import memory as devmem
from mmlspark_tpu_torch.reliability.breaker import CircuitBreaker, CircuitOpen
from mmlspark_tpu_torch.utils import config as mmlconfig
from mmlspark_tpu_torch.utils.logging import get_logger

logger = get_logger("observability.aggregate")

# server.stats() keys that are monotonic counts (everything else numeric
# is exported as a gauge)
_COUNTER_KEYS = frozenset((
    "admitted", "shed", "expired", "completed", "failed",
    "registry.evictions", "registry.compiles", "registry.compile_cache_hits",
))

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: _LabelKey) -> str:
    return ",".join(f'{k}="{metrics.escape_label_value(v)}"'
                    for k, v in key)


class AggregatedRegistry:
    """Labeled series store + Prometheus/JSON export.

    The process :class:`~mmlspark_tpu_torch.observability.metrics.MetricsRegistry`
    is intentionally label-free (hot-path cost); this one exists for the
    scraped fleet view where every sample already paid its collection
    cost on the replica.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # name -> {"type": t, "series": {label_key: sample}}
        self._metrics: Dict[str, Dict[str, Any]] = {}

    def set_value(self, name: str, labels: Dict[str, str], value: float,
                  mtype: str = "gauge") -> None:
        if mtype not in ("gauge", "counter"):
            raise ValueError(f"mtype must be gauge|counter, got {mtype!r}")
        with self._lock:
            m = self._metrics.setdefault(name, {"type": mtype, "series": {}})
            m["series"][_label_key(labels)] = float(value)

    def set_histogram(self, name: str, labels: Dict[str, str],
                      buckets: Dict[str, float], sum_: float, count: float,
                      exemplar: Optional[Dict[str, Any]] = None) -> None:
        with self._lock:
            m = self._metrics.setdefault(
                name, {"type": "histogram", "series": {}})
            m["series"][_label_key(labels)] = {
                "buckets": dict(buckets), "sum": float(sum_),
                "count": float(count),
                **({"exemplar": dict(exemplar)} if exemplar else {})}

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            items = sorted(self._metrics.items())
            out: Dict[str, Any] = {}
            for name, m in items:
                series = []
                for key, sample in sorted(m["series"].items()):
                    entry: Dict[str, Any] = {"labels": dict(key)}
                    if m["type"] == "histogram":
                        entry.update(sample)
                    else:
                        entry["value"] = sample
                    series.append(entry)
                out[name] = {"type": m["type"], "series": series}
            return out

    def prometheus_text(self) -> str:
        """One exposition page for the whole fleet: every series labeled
        (``replica=``, ``model=``/``kind=`` ...), one ``# TYPE`` header
        per metric name."""
        lines: List[str] = []
        with self._lock:
            items = sorted((n, dict(m, series=dict(m["series"])))
                           for n, m in self._metrics.items())
        for name, m in items:
            pname = metrics.sanitize(name)
            lines.append(f"# TYPE {pname} {m['type']}")
            for key, sample in sorted(m["series"].items()):
                ls = _label_str(key)
                if m["type"] == "histogram":
                    for le, c in sample["buckets"].items():
                        esc = metrics.escape_label_value(le)
                        sep = "," if ls else ""
                        lines.append(
                            f'{pname}_bucket{{{ls}{sep}le="{esc}"}} '
                            f"{metrics._fmt(c)}")
                    lines.append(
                        f"{pname}_sum{{{ls}}} {metrics._fmt(sample['sum'])}")
                    lines.append(
                        f"{pname}_count{{{ls}}} "
                        f"{metrics._fmt(sample['count'])}")
                else:
                    lines.append(f"{pname}{{{ls}}} {metrics._fmt(sample)}")
        return "\n".join(lines) + ("\n" if lines else "")


def parse_prometheus_text(text: str) -> Dict[str, Any]:
    """Parse a Prometheus text exposition back into
    ``{name: {"type", "value"}}`` scalars and
    ``{name: {"type": "histogram", "buckets", "sum", "count"}}``
    histograms — the inverse of ``MetricsRegistry.prometheus_text`` (the
    subset this framework emits: no labels other than ``le``).
    Malformed lines are skipped, not fatal."""
    out: Dict[str, Any] = {}
    types: Dict[str, str] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        try:
            lhs, value = line.rsplit(None, 1)
            v = float(value)
        except ValueError:
            continue
        labels: Dict[str, str] = {}
        name = lhs
        if "{" in lhs and lhs.endswith("}"):
            name, _, rest = lhs.partition("{")
            for part in rest[:-1].split(","):
                if "=" in part:
                    lk, _, lv = part.partition("=")
                    labels[lk.strip()] = lv.strip().strip('"')
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and \
                    types.get(name[:-len(suffix)]) == "histogram":
                base = name[:-len(suffix)]
                break
        if base != name or types.get(base) == "histogram":
            h = out.setdefault(base, {"type": "histogram", "buckets": {},
                                      "sum": 0.0, "count": 0.0})
            if name.endswith("_bucket"):
                h["buckets"][labels.get("le", "+Inf")] = v
            elif name.endswith("_sum"):
                h["sum"] = v
            elif name.endswith("_count"):
                h["count"] = v
        else:
            out[name] = {"type": types.get(name, "gauge"), "value": v}
    return out


def merge_cumulative(dicts: Iterable[Dict[str, float]]) -> Dict[str, float]:
    """Sum cumulative ``{le: count}`` histograms across replicas (bucket
    edges are shared fleet-wide — all replicas run the same config)."""
    merged: Dict[str, float] = {}
    for d in dicts:
        for le, c in d.items():
            merged[le] = merged.get(le, 0.0) + float(c)
    return merged


def merge_event_logs(paths: Sequence[str]) -> List[Dict[str, Any]]:
    """Load + merge several JSONL event logs (per-pid sidecars, one per
    process) into one ts-ordered stream. Torn lines are counted and
    skipped (:func:`~mmlspark_tpu_torch.observability.report.load_events`);
    spans are not deduplicated here."""
    from mmlspark_tpu_torch.observability import report as _report
    merged: List[Dict[str, Any]] = []
    for p in paths:
        merged.extend(_report.load_events(p))
    merged.sort(key=lambda e: float(e.get("ts", 0.0)))
    return merged


def expand_event_paths(paths: Sequence[str],
                       pattern: Optional[str] = None) -> List[str]:
    """Expand explicit paths plus an optional glob into a sorted,
    de-duplicated path list."""
    out: List[str] = []
    for p in paths or ():
        if any(ch in str(p) for ch in "*?["):
            out.extend(sorted(_glob.glob(str(p))))
        else:
            out.append(str(p))
    if pattern:
        out.extend(sorted(_glob.glob(str(pattern))))
    seen: Dict[str, None] = {}
    for p in out:
        seen.setdefault(p, None)
    return list(seen)


class FleetScraper:
    """Poll every replica for readiness + metrics and merge the result.

    ``replicas`` may be a :class:`~mmlspark_tpu_torch.serve.fleet.Fleet`, a
    :class:`~mmlspark_tpu_torch.serve.router.Router`, or a plain list of
    replica objects (anything with ``name`` + ``health()``; in-process
    replicas additionally expose ``.server``, HTTP ones ``.addr``).

    Every target is scraped through its own circuit breaker
    (``scrape.<name>``): a replica that times out or refuses repeatedly
    trips open and is skipped (marked ``circuit_open`` in the snapshot)
    until the cooldown's half-open probe — the scrape loop never blocks
    the dashboard on one dead host. ``clock`` injects time for both the
    snapshot timestamps and the breaker cooldowns.
    """

    def __init__(self, replicas: Any, *, clock: Optional[Callable] = None,
                 breaker_failures: Optional[int] = None,
                 breaker_reset_s: Optional[float] = None,
                 timeout_s: float = 2.0):
        router = getattr(replicas, "router", None)   # Fleet
        if router is not None:
            self.router: Optional[Any] = router
            reps = [h.replica for h in router._handles.values()]
        elif hasattr(replicas, "_handles"):          # Router
            self.router = replicas
            reps = [h.replica for h in replicas._handles.values()]
        else:
            self.router = None
            reps = list(replicas)
        self.replicas = reps
        self.clock = clock or events.wall
        self.timeout_s = float(timeout_s)
        self._breaker_failures = breaker_failures
        self._breaker_reset_s = breaker_reset_s
        self._breakers = {
            r.name: CircuitBreaker(f"scrape.{r.name}",
                                   failure_threshold=breaker_failures,
                                   reset_timeout_s=breaker_reset_s,
                                   clock=self.clock)
            for r in reps}
        self.registry = AggregatedRegistry()
        self._last: Optional[Dict[str, Any]] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- one replica -------------------------------------------------------
    def _scrape_http(self, replica: Any) -> Dict[str, Any]:
        import urllib.request
        base = replica.addr
        with urllib.request.urlopen(base + "/metrics",
                                    timeout=self.timeout_s) as resp:
            parsed = parse_prometheus_text(
                resp.read().decode("utf-8", "replace"))
        try:
            with urllib.request.urlopen(base + "/readyz",
                                        timeout=self.timeout_s) as resp:
                ready = resp.status == 200
            live = True
        except Exception as e:
            status = getattr(e, "code", None)
            if status is None:
                raise
            ready, live = False, True  # answered, just not ready
        stats: Dict[str, float] = {}
        for key in ("admitted", "shed", "expired", "completed", "failed",
                    "queue_depth", "inflight"):
            m = parsed.get(f"serving_{key}")
            if m is not None and "value" in m:
                stats[key] = m["value"]
        latency = parsed.get("serving_total_ms")
        if latency is not None and latency.get("type") == "histogram":
            stats["p50_ms"] = round(metrics.percentile_from_buckets(
                latency["buckets"], 50), 3)
            stats["p99_ms"] = round(metrics.percentile_from_buckets(
                latency["buckets"], 99), 3)
        # prefix-digest advertisement (metrics-adjacent JSON endpoint;
        # serve/http.py). Best-effort: an older replica without the
        # route is still a healthy scrape target.
        try:
            import json as _json
            with urllib.request.urlopen(base + "/affinity",
                                        timeout=self.timeout_s) as resp:
                adv = _json.loads(resp.read().decode("utf-8", "replace"))
            for model, d in (adv.get("digests") or {}).items():
                stats[f"generate.{model}.kv.resident_chains"] = \
                    d.get("chains") or []
                stats[f"generate.{model}.kv.kv_dtype"] = \
                    str(d.get("kv_dtype") or "")
                stats[f"generate.{model}.kv.block_tokens"] = \
                    d.get("block_tokens")
        except Exception as e:
            logger.debug("affinity scrape skipped for %s: %s", base, e)
        return {"ready": ready, "live": live,
                "state": "ready" if ready else "draining",
                "stats": stats, "latency": latency, "metrics": parsed}

    def _scrape_inproc(self, replica: Any) -> Dict[str, Any]:
        server = replica.server
        health = replica.health()
        stats = server.stats()
        lat = server.latency
        latency = {"type": "histogram", "buckets": lat.cumulative(),
                   "sum": lat.sum, "count": lat.count}
        if lat.exemplar is not None:
            latency["exemplar"] = dict(lat.exemplar)
        return {"ready": bool(health.get("ready")),
                "live": bool(health.get("live")),
                "state": str(health.get("state", "")),
                "stats": stats, "latency": latency}

    def _scrape_one(self, replica: Any) -> Dict[str, Any]:
        if hasattr(replica, "server"):
            return self._scrape_inproc(replica)
        if hasattr(replica, "addr"):
            return self._scrape_http(replica)
        health = replica.health()  # minimal duck-typed fallback
        return {"ready": bool(health.get("ready")),
                "live": bool(health.get("live")),
                "state": str(health.get("state", "")),
                "stats": {}, "latency": None}

    def _refresh_replicas(self) -> None:
        """Re-read the router's handle set so replicas added/removed by
        the autopilot's scale lever appear in the very next scrape (the
        founding list used to be frozen at construction). Breakers are
        created lazily for new names and kept for departed ones, so a
        re-added name resumes its breaker history."""
        if self.router is None:
            return
        reps = [h.replica for h in self.router._handles.values()]
        self.replicas = reps
        for r in reps:
            if r.name not in self._breakers:
                self._breakers[r.name] = CircuitBreaker(
                    f"scrape.{r.name}",
                    failure_threshold=self._breaker_failures,
                    reset_timeout_s=self._breaker_reset_s,
                    clock=self.clock)

    # -- the scrape --------------------------------------------------------
    def scrape(self) -> Dict[str, Any]:
        """One full pass over every replica -> merged snapshot. Never
        raises: per-replica failures are recorded in the snapshot (and
        fed to that replica's breaker)."""
        t0 = events.perf()
        self._refresh_replicas()
        snap: Dict[str, Any] = {"ts": float(self.clock()), "replicas": {}}
        totals: Dict[str, float] = {}
        latencies: List[Dict[str, float]] = []
        for replica in self.replicas:
            name = replica.name
            breaker = self._breakers[name]
            try:
                one = breaker.call(self._scrape_one, replica)
            except CircuitOpen:
                one = {"ready": False, "live": False, "state": "unknown",
                       "stats": {}, "latency": None,
                       "error": "circuit_open"}
            except Exception as e:
                one = {"ready": False, "live": False, "state": "unknown",
                       "stats": {}, "latency": None,
                       "error": f"{type(e).__name__}: {e}"}
            one["breaker"] = breaker.state
            snap["replicas"][name] = one
            for k, v in one["stats"].items():
                if isinstance(v, (int, float)):
                    totals[k] = totals.get(k, 0.0) + float(v)
            if one.get("latency"):
                latencies.append(one["latency"])
        if latencies:
            merged = merge_cumulative(l["buckets"] for l in latencies)
            totals["p50_ms"] = round(
                metrics.percentile_from_buckets(merged, 50), 3)
            totals["p99_ms"] = round(
                metrics.percentile_from_buckets(merged, 99), 3)
            snap["latency"] = {
                "buckets": merged,
                "sum": sum(l["sum"] for l in latencies),
                "count": sum(l["count"] for l in latencies)}
        if self.router is not None:
            rs = self.router.stats()
            totals["failovers"] = float(rs.get("failovers", 0))
            totals["all_shed"] = float(rs.get("all_shed", 0))
            snap["router"] = rs
        self._publish_digests(snap)
        snap["fleet"] = totals
        snap["memory"] = devmem.get_ledger().snapshot()
        self._last = snap
        self._update_registry(snap)
        dt_ms = (events.perf() - t0) * 1e3
        metrics.histogram("fleet.scrape_ms").observe(dt_ms)
        snap["scrape_ms"] = round(dt_ms, 3)
        return snap

    @property
    def last(self) -> Optional[Dict[str, Any]]:
        return self._last

    def _publish_digests(self, snap: Dict[str, Any]) -> None:
        """Fleet-wide prefix-digest pull: each replica's ``generate.<model>.kv.resident_chains``
        summary — a structured stats value the numeric totals above
        skip — is published into the router's shared
        :class:`~mmlspark_tpu_torch.serve.affinity.AffinityState`, which is
        what the router scores generate picks against. A no-op without
        a router or with affinity disabled."""
        aff = getattr(self.router, "affinity", None)
        if aff is None:
            return
        tail = ".kv.resident_chains"
        for name, one in snap["replicas"].items():
            stats = one.get("stats") or {}
            for k, v in stats.items():
                if not (k.startswith("generate.") and k.endswith(tail)
                        and isinstance(v, list)):
                    continue
                model = k[len("generate."):-len(tail)]
                aff.update_digest(
                    name, model, v,
                    kv_dtype=stats.get(f"generate.{model}.kv.kv_dtype"),
                    block_tokens=stats.get(
                        f"generate.{model}.kv.block_tokens"),
                    ts=snap["ts"])
        snap["affinity"] = aff.snapshot()

    def _update_registry(self, snap: Dict[str, Any]) -> None:
        reg = self.registry
        reg.clear()
        for name, one in snap["replicas"].items():
            labels = {"replica": name}
            reg.set_value("fleet.replica_ready", labels,
                          1.0 if one["ready"] else 0.0)
            reg.set_value("fleet.replica_live", labels,
                          1.0 if one["live"] else 0.0)
            for k, v in one["stats"].items():
                if not isinstance(v, (int, float)):
                    continue
                mtype = "counter" if k in _COUNTER_KEYS else "gauge"
                reg.set_value(f"serving.{k}", labels, v, mtype)
            lat = one.get("latency")
            if lat:
                reg.set_histogram("serving.total_ms", labels,
                                  lat["buckets"], lat["sum"], lat["count"],
                                  exemplar=lat.get("exemplar"))
        for (model, kinds) in snap["memory"]["by_model"].items():
            for kind, nbytes in kinds.items():
                reg.set_value("memory.bytes", {"model": model, "kind": kind},
                              nbytes)
        reg.set_value("memory.hbm_bytes", {},
                      snap["memory"]["total_bytes"])
        reg.set_value("memory.hbm_high_watermark_bytes", {},
                      snap["memory"]["high_watermark_bytes"])
        if self.router is not None and "router" in snap:
            reg.set_value("fleet.failovers", {},
                          snap["fleet"].get("failovers", 0.0), "counter")
            reg.set_value("fleet.all_shed", {},
                          snap["fleet"].get("all_shed", 0.0), "counter")

    # -- exports -----------------------------------------------------------
    def prometheus_text(self) -> str:
        if self._last is None:
            self.scrape()
        return self.registry.prometheus_text()

    def to_dict(self) -> Dict[str, Any]:
        if self._last is None:
            self.scrape()
        return self.registry.to_dict()

    # -- SLO bridge --------------------------------------------------------
    def slo_sample(self,
                   snapshot: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
        """Distill one scrape into the cumulative totals the SLO engine
        windows over: ``admitted`` (good+bad demand), ``bad`` (shed +
        expired + failed + router failovers — every request the fleet
        did not serve first-try), and the merged latency buckets."""
        snap = snapshot if snapshot is not None else self.scrape()
        fleet = snap.get("fleet", {})
        bad = (fleet.get("shed", 0.0) + fleet.get("expired", 0.0)
               + fleet.get("failed", 0.0) + fleet.get("failovers", 0.0))
        sample = {"t": float(snap["ts"]),
                  "admitted": float(fleet.get("admitted", 0.0)),
                  "bad": float(bad)}
        lat = snap.get("latency")
        if lat:
            sample["latency_buckets"] = dict(lat["buckets"])
        ttft = metrics.get_registry().to_dict().get("generate.ttft_ms")
        if ttft and ttft.get("type") == "histogram":
            sample["ttft_buckets"] = dict(ttft["buckets"])
        return sample

    # -- background loop ---------------------------------------------------
    def start(self, interval_s: Optional[float] = None) -> None:
        """Scrape on a daemon thread every ``interval_s`` (default
        ``observability.scrape_interval_s``) until :meth:`stop`."""
        if self._thread is not None:
            return
        interval = float(interval_s if interval_s is not None
                         else mmlconfig.get(
                             "observability.scrape_interval_s"))

        def loop() -> None:
            while not self._stop.wait(interval):
                try:
                    self.scrape()
                except Exception:  # pragma: no cover - defensive
                    logger.exception("fleet scrape failed")

        self._stop.clear()
        self._thread = threading.Thread(
            target=loop, name="mmlspark-tpu-torch-scraper", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None
