"""Declarative SLOs with multi-window burn-rate alerting.

The port's copy of ``mmlspark_tpu/observability/slo.py``.

Objectives come from the ``slo.*`` config namespace and are evaluated
against the aggregated fleet view (:meth:`FleetScraper.slo_sample`):

- **availability** — ``1 - bad/admitted`` against
  ``slo.availability_target`` (``bad`` = shed + expired + failed +
  router failovers: every request the fleet did not serve first-try);
- **latency** — "99% of requests complete within ``slo.latency_p99_ms``"
  (0 = objective off), measured from the merged total-latency buckets;
- **ttft** — same shape for the generate lane's time-to-first-token
  against ``slo.ttft_p99_ms``.

Alerting is the standard SRE-workbook multi-window recipe: the burn
rate (bad fraction over the window, divided by the error budget) is
computed over a FAST window (``slo.fast_window_s``, default 5m — pages
fast on a cliff) and a SLOW window (``slo.slow_window_s``, default 1h —
filters blips). ``burning`` = fast burn over ``slo.fast_burn``;
``breaching`` = BOTH windows over their thresholds. Transitions are
edge-triggered events — ``slo.burn`` / ``slo.breach`` / ``slo.recover``
— which land in the event log (the port has no flight recorder yet), so
a post-mortem shows exactly when the budget started burning.

The engine is pure arithmetic over (clock, cumulative-counter) samples:
inject ``clock`` and feed :meth:`SloEngine.observe` synthetic samples to
test window behavior deterministically.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from mmlspark_tpu_torch.observability import events, metrics
from mmlspark_tpu_torch.utils import config as mmlconfig

_THRESHOLD_PCT = 99.0  # latency/ttft objectives are "99% under budget"


def fraction_le(cumulative: Dict[str, float], x: float) -> float:
    """Interpolated fraction of observations <= ``x`` from a cumulative
    ``{le: count}`` mapping (1.0 for an empty histogram — no traffic
    means no budget burned)."""
    finite: List[tuple] = []
    total = 0.0
    for le, c in cumulative.items():
        if isinstance(le, str) and le.strip().lstrip("+") in ("Inf", "inf"):
            total = float(c)
        else:
            finite.append((float(le), float(c)))
    finite.sort()
    if total <= 0:
        total = finite[-1][1] if finite else 0.0
    if total <= 0:
        return 1.0
    prev_b, prev_c = 0.0, 0.0
    for b, c in finite:
        if x <= b:
            span = b - prev_b
            frac = (x - prev_b) / span if span > 0 else 1.0
            return (prev_c + (c - prev_c) * max(0.0, min(1.0, frac))) / total
        prev_b, prev_c = b, c
    return (finite[-1][1] if finite else total) / total


class Objective:
    """One declarative objective: a name, a target fraction of good
    events, and how to extract (good, bad) totals from a sample."""

    def __init__(self, name: str, kind: str, target: float,
                 budget_ms: float = 0.0):
        if not 0.0 < target < 1.0:
            raise ValueError(f"slo {name}: target must be in (0, 1), "
                             f"got {target}")
        self.name = name
        self.kind = kind          # availability | latency | ttft
        self.target = float(target)
        self.budget_ms = float(budget_ms)

    @property
    def error_budget(self) -> float:
        return 1.0 - self.target

    def totals(self, sample: Dict[str, Any]) -> Optional[tuple]:
        """Cumulative ``(events, bad)`` as of this sample, or None when
        the sample does not carry this objective's inputs."""
        if self.kind == "availability":
            admitted = float(sample.get("admitted", 0.0))
            return admitted, float(sample.get("bad", 0.0))
        key = "latency_buckets" if self.kind == "latency" else "ttft_buckets"
        buckets = sample.get(key)
        if buckets is None:
            return None
        total = 0.0
        for le, c in buckets.items():
            total = max(total, float(c))
        good = fraction_le(buckets, self.budget_ms) * total
        return total, total - good


def objectives_from_config() -> List[Objective]:
    """The active objective set per ``slo.*`` (latency/ttft join only
    when their budget keys are > 0)."""
    out = [Objective("availability", "availability",
                     float(mmlconfig.get("slo.availability_target")))]
    lat = float(mmlconfig.get("slo.latency_p99_ms"))
    if lat > 0:
        out.append(Objective("latency_p99", "latency",
                             _THRESHOLD_PCT / 100.0, budget_ms=lat))
    ttft = float(mmlconfig.get("slo.ttft_p99_ms"))
    if ttft > 0:
        out.append(Objective("ttft_p99", "ttft",
                             _THRESHOLD_PCT / 100.0, budget_ms=ttft))
    return out


class SloEngine:
    """Rolling-window burn-rate evaluation over scrape samples.

    Feed :meth:`observe` one :meth:`FleetScraper.slo_sample` per scrape;
    each call re-evaluates every objective over the fast and slow
    windows and returns the per-objective status list (also kept on
    :meth:`status`). Counter resets (a replica restart shrinking the
    cumulative totals) drop the affected history rather than computing
    negative deltas.
    """

    def __init__(self, objectives: Optional[List[Objective]] = None, *,
                 clock: Optional[Callable[[], float]] = None,
                 fast_window_s: Optional[float] = None,
                 slow_window_s: Optional[float] = None,
                 fast_burn: Optional[float] = None,
                 slow_burn: Optional[float] = None):
        self.objectives = objectives if objectives is not None \
            else objectives_from_config()
        self.clock = clock or events.wall
        self.fast_window_s = float(
            fast_window_s if fast_window_s is not None
            else mmlconfig.get("slo.fast_window_s"))
        self.slow_window_s = float(
            slow_window_s if slow_window_s is not None
            else mmlconfig.get("slo.slow_window_s"))
        self.fast_burn = float(fast_burn if fast_burn is not None
                               else mmlconfig.get("slo.fast_burn"))
        self.slow_burn = float(slow_burn if slow_burn is not None
                               else mmlconfig.get("slo.slow_burn"))
        # per-objective history: [(t, total_events, bad_events), ...]
        self._history: Dict[str, List[tuple]] = {
            o.name: [] for o in self.objectives}
        self._burning: Dict[str, bool] = {}
        self._breaching: Dict[str, bool] = {}
        self._status: List[Dict[str, Any]] = []

    # -- windows -----------------------------------------------------------
    def _window_burn(self, obj: Objective, hist: List[tuple],
                     now: float, window_s: float) -> float:
        """Burn rate over ``[now - window_s, now]``: bad fraction of the
        events in the window, divided by the error budget. No events in
        the window = no burn."""
        if not hist:
            return 0.0
        cur = hist[-1]
        cutoff = now - window_s
        # reference = last sample at-or-before the window start (so the
        # delta covers the whole window), else the oldest we have
        ref = hist[0]
        for s in hist:
            if s[0] <= cutoff:
                ref = s
            else:
                break
        d_events = cur[1] - ref[1]
        d_bad = cur[2] - ref[2]
        if d_events <= 0:
            return 0.0
        bad_fraction = max(0.0, min(1.0, d_bad / d_events))
        return bad_fraction / max(obj.error_budget, 1e-9)

    # -- the step ----------------------------------------------------------
    def observe(self, sample: Dict[str, Any]) -> List[Dict[str, Any]]:
        now = float(sample.get("t", self.clock()))
        status: List[Dict[str, Any]] = []
        keep_after = now - self.slow_window_s * 1.5
        for obj in self.objectives:
            totals = obj.totals(sample)
            hist = self._history[obj.name]
            if totals is not None:
                if hist and (totals[0] < hist[-1][1]
                             or totals[1] < hist[-1][2]):
                    hist.clear()  # counter reset (replica restart)
                hist.append((now, float(totals[0]), float(totals[1])))
                while len(hist) > 2 and hist[1][0] <= keep_after:
                    hist.pop(0)
            fast = self._window_burn(obj, hist, now, self.fast_window_s)
            slow = self._window_burn(obj, hist, now, self.slow_window_s)
            burning = fast >= self.fast_burn
            breaching = burning and slow >= self.slow_burn
            st = {"objective": obj.name, "kind": obj.kind,
                  "target": obj.target, "budget_ms": obj.budget_ms,
                  "burn_fast": round(fast, 4), "burn_slow": round(slow, 4),
                  "burning": burning, "breaching": breaching}
            self._emit_transitions(obj, st)
            metrics.gauge(f"slo.burn_fast.{obj.name}").set(fast)
            metrics.gauge(f"slo.burn_slow.{obj.name}").set(slow)
            status.append(st)
        self._status = status
        return status

    def _emit_transitions(self, obj: Objective,
                          st: Dict[str, Any]) -> None:
        """Edge-triggered slo.burn / slo.breach / slo.recover events,
        through events.emit."""
        was_burning = self._burning.get(obj.name, False)
        was_breaching = self._breaching.get(obj.name, False)
        self._burning[obj.name] = st["burning"]
        self._breaching[obj.name] = st["breaching"]
        log = events.recording_enabled()
        fields = {"objective": obj.name, "burn_fast": st["burn_fast"],
                  "burn_slow": st["burn_slow"], "target": obj.target}
        if st["burning"] and not was_burning:
            metrics.counter("slo.burns").inc()
            if log:
                events.emit("slo", "burn", **fields)
        if st["breaching"] and not was_breaching:
            metrics.counter("slo.breaches").inc()
            if log:
                events.emit("slo", "breach", **fields)
        if was_breaching and not st["breaching"] and log:
            events.emit("slo", "recover", **fields)

    def status(self) -> List[Dict[str, Any]]:
        """Most recent per-objective evaluation (empty before the first
        observe)."""
        return list(self._status)
