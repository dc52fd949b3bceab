"""Bench regression gate: fresh bench line vs a committed baseline.

The port's copy of ``mmlspark_tpu/observability/benchgate.py`` (pure data,
kept verbatim so both packages gate a bench line the same way).

``mmlspark-tpu-torch bench --baseline BENCH_r05.json`` (or ``./bench.py
--baseline ...``) runs the bench as usual, then compares the fresh
one-line JSON result against the committed baseline per lane:

- ``value`` (the lane's headline throughput) must not drop more than the
  tolerance below the baseline;
- ``step_ms`` must not rise more than the tolerance above it;
- ``mfu`` must not drop more than the tolerance below it;
- ``ttft_p99_ms`` (serving lanes) must not rise more than the tolerance
  above it;
- ``shed_rate`` / ``spike_p99_ms`` (the autopilot lane) must not rise
  more than the tolerance above it — a controller change that sheds
  more or recovers slower under the seeded spike is a regression;
- ``goodput`` (open-loop lanes: fraction of OFFERED requests answered
  within the lane's deadline) must not drop more than the tolerance
  below it, and ``arrival_p99_ms`` (latency from the INTENDED arrival
  time, un-clipped) must not rise more than the tolerance above it.

Tail-latency percentiles carry two noise guards the ratio gate lacks:
an absolute resolution floor — a ``*_p99_ms`` check whose rise is
within ``_MS_RESOLUTION`` (5 ms) passes even past the ratio tolerance,
because on a single-digit-ms percentile the ratio gate would red on
sub-millisecond host scheduler jitter no bench host can resolve (the
check records ``floor_ms`` when the floor is what saved it) — and
deep-headroom absorption: when BOTH sides of the comparison sit within
10% of the lane's ``deadline_ms``, the percentile is measuring host
noise far from the saturation knee, not SLO behaviour (goodput is the
gated signal there), so the check passes and records ``headroom_ms``.
A rise that crosses OUT of the headroom band still reds. ``step_ms``
gets neither guard: it is a mean over many steps, where a 2 ms rise is
signal, not noise.

Clipped percentiles are never parity evidence. A latency percentile
that sits exactly at the lane's ``deadline_ms`` — or that the lane
marks ``<field>_clipped`` — is a FLOOR, not a value: the true
percentile is somewhere above it. So a clipped fresh value against an
un-clipped baseline is a regression outright (the fresh run saturated
where the baseline did not), while any comparison against a clipped
baseline is demoted to informational (``clipped-vs-clipped`` showing
90000 vs 90000 proves nothing — exactly the blind spot that hid the
r08 spike regression). A legacy baseline lane that predates the
open-loop rework (it has ``spike_p99_ms`` but neither ``deadline_ms``
nor ``arrival_p99_ms``) cannot even be tested for clipping, so its
``spike_p99_ms`` is informational too — the transition can never
false-fail.

A lane that was budget-skipped (or terminated) in EITHER run is marked
``skipped``, never red — congestion on the bench host must not fail CI.
A lane missing a field in the baseline simply skips that check. The
verdict is printed as a second JSON line on stdout and the process exits
0 iff every checked lane is green.

Baselines are accepted in both shapes the repo produces: the raw bench
line (``{"metric", "value", "configs": {...}}``) and the driver wrapper
committed as BENCH_r05.json (``{"n", "cmd", "rc", "parsed": <line>}``).

Pure data in, data out — no jax, no bench imports — so the comparison is
unit-testable without running a single bench step.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Optional

# 10%: wide enough to ride out shared-host noise on a 5-rep bench, tight
# enough to catch the 20%+ cliffs a bad dispatch-path change causes.
DEFAULT_TOLERANCE = 0.10


def load_baseline(path: str) -> Dict[str, Any]:
    """Read a committed baseline; unwraps the ``{"parsed": ...}`` driver
    wrapper when present. Raises ValueError when no bench line with a
    ``configs`` map can be found."""
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if isinstance(data, dict) and isinstance(data.get("parsed"), dict):
        data = data["parsed"]
    if not isinstance(data, dict) or not isinstance(data.get("configs"),
                                                    dict):
        raise ValueError(
            f"{path}: not a bench baseline (expected a bench line with a "
            "'configs' map, or a wrapper with 'parsed')")
    return data


def _num(lane: Dict[str, Any], field: str) -> Optional[float]:
    v = lane.get(field)
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return float(v)


# latency percentiles that can saturate at a lane deadline; everything in
# the clipped-handling path below applies to these and only these
_LATENCY_FIELDS = ("ttft_p99_ms", "spike_p99_ms", "arrival_p99_ms")


def clipped(lane: Dict[str, Any], field: str) -> bool:
    """Is this lane's latency percentile a deadline-saturated FLOOR
    rather than a measured value? True when the lane says so outright
    (``<field>_clipped``) or when the value sits EXACTLY at the lane's
    ``deadline_ms`` — the saturated-top-bucket signature. An honest
    open-loop measurement ABOVE the deadline is not clipped: that is a
    real (bad) number, and gating it is the whole point."""
    if lane.get(f"{field}_clipped") is True:
        return True
    v = _num(lane, field)
    d = _num(lane, "deadline_ms")
    return v is not None and d is not None and d > 0 and v == d


def _legacy_closed_loop(lane: Dict[str, Any]) -> bool:
    """A pre-open-loop baseline lane: it reports ``spike_p99_ms`` but
    carries neither the deadline nor the arrival-time percentile, so its
    latency numbers cannot even be tested for clipping (r08 and earlier
    committed 90000.0-clipped values as if they were measurements)."""
    return ("spike_p99_ms" in lane and "deadline_ms" not in lane
            and "arrival_p99_ms" not in lane)


# absolute resolution floor for tail-latency percentiles: below this, a
# difference is host scheduler jitter, not a regression — a 10% ratio
# gate on an 8 ms p99 would be red over 0.8 ms of noise no measurement
# on a shared-core bench host can resolve. Applies ONLY to the
# percentile fields in _LATENCY_FIELDS: step_ms is a mean over many
# steps, where a 2 ms rise IS signal.
_MS_RESOLUTION = 5.0

# deep-headroom band for tail-latency percentiles: when both sides of a
# comparison sit within this fraction of the lane's deadline, the p99
# is nowhere near the queueing knee and its movement is host noise —
# goodput (gated) is the SLO signal in that regime. A shared-core
# bench host can turn an 8 ms p99 into 19 ms between identical runs; a
# real saturation drift blows past 10% of the deadline immediately.
_HEADROOM_FRAC = 0.10


def _check(name: str, fresh_v: Optional[float], base_v: Optional[float],
           tolerance: float, higher_is_better: bool) -> Optional[Dict[str, Any]]:
    """One metric comparison; None when either side can't be checked
    (missing field, or a zero/negative baseline that makes a ratio
    meaningless)."""
    if fresh_v is None or base_v is None or base_v <= 0:
        return None
    ratio = fresh_v / base_v
    if higher_is_better:
        ok = ratio >= 1.0 - tolerance
    else:
        ok = ratio <= 1.0 + tolerance
    out = {"metric": name, "fresh": fresh_v, "baseline": base_v,
           "ratio": round(ratio, 4), "tolerance": tolerance, "ok": ok}
    if (not ok and not higher_is_better and name in _LATENCY_FIELDS
            and fresh_v - base_v <= _MS_RESOLUTION):
        out["ok"] = True
        out["floor_ms"] = _MS_RESOLUTION
    return out


def compare(fresh: Dict[str, Any], baseline: Dict[str, Any],
            tolerance: float = DEFAULT_TOLERANCE) -> Dict[str, Any]:
    """Per-lane comparison of a fresh bench line against a baseline line.

    Returns the verdict dict: ``{"gate": ..., "green": bool, "lanes":
    {name: {"status": green|red|skipped, "checks": [...], "reasons":
    [...]}}, "red": [...], "skipped": [...]}``.
    """
    fresh_cfg = fresh.get("configs") or {}
    base_cfg = baseline.get("configs") or {}
    lanes: Dict[str, Any] = {}
    red, skipped = [], []
    for name in sorted(base_cfg):
        base_lane = base_cfg.get(name) or {}
        fresh_lane = fresh_cfg.get(name)
        if base_lane.get("skipped"):
            lanes[name] = {"status": "skipped",
                           "reasons": ["skipped in baseline"]}
            skipped.append(name)
            continue
        if fresh_lane is None or fresh_lane.get("skipped"):
            reason = (fresh_lane or {}).get("reason", "lane did not run")
            lanes[name] = {"status": "skipped", "reasons": [str(reason)]}
            skipped.append(name)
            continue
        checks = []
        for field, higher in (("value", True), ("step_ms", False),
                              ("mfu", True), ("ttft_p99_ms", False),
                              ("shed_rate", False),
                              ("spike_p99_ms", False),
                              ("goodput", True),
                              ("arrival_p99_ms", False),
                              # fleet-wide prefix re-use under affinity
                              # routing: a change that stops the router
                              # steering repeats to warm replicas IS a
                              # regression, so this one gates
                              ("fleet_prefix_hit_rate", True)):
            c = _check(field, _num(fresh_lane, field),
                       _num(base_lane, field), tolerance, higher)
            if c is None:
                continue
            if field in _LATENCY_FIELDS:
                fresh_clip = clipped(fresh_lane, field)
                base_clip = clipped(base_lane, field)
                if fresh_clip:
                    c["clipped"] = True
                if base_clip:
                    c["baseline_clipped"] = True
                legacy = (field == "spike_p99_ms"
                          and _legacy_closed_loop(base_lane))
                if base_clip or legacy:
                    # the baseline number is a floor (or can't be told
                    # from one): a ratio against it proves nothing in
                    # either direction — report, never red, and never
                    # count clipped-vs-clipped as parity
                    c["ok"] = True
                    c["informational"] = True
                    c["note"] = (
                        "clipped-vs-clipped: not parity evidence"
                        if fresh_clip and base_clip else
                        "baseline is a clipped/legacy closed-loop "
                        "floor; not comparable")
                elif fresh_clip:
                    # the fresh run saturated where the baseline did
                    # not — a regression even at ratio 1.0
                    c["ok"] = False
                    c["note"] = ("fresh percentile clipped at the "
                                 "deadline; baseline was un-clipped")
                elif not c["ok"]:
                    # deep-headroom absorption: both sides far inside
                    # the deadline — see _HEADROOM_FRAC
                    d = (_num(fresh_lane, "deadline_ms")
                         or _num(base_lane, "deadline_ms"))
                    band = _HEADROOM_FRAC * d if d and d > 0 else None
                    if (band is not None and c["fresh"] <= band
                            and c["baseline"] <= band):
                        c["ok"] = True
                        c["headroom_ms"] = band
                        c["note"] = ("deep headroom: both sides within "
                                     "10% of the deadline")
            checks.append(c)
        # compile_ms / cold_start_ms are INFORMATIONAL: cold-start cost
        # swings with cache state and host load, so the comparison is
        # reported (so the compile-cache win is a visible number) but can
        # never flip a lane red. Prefix hit rate and speculative
        # acceptance are workload signatures, not regressions — reported
        # so a cache-defeating change is visible, never red. Per-shard
        # HBM (shard_bytes_max) tracks the mesh topology, not the code
        # under test — reported so the crossing-the-chip win is a
        # visible number, never red.
        # Decision counts and recovery time are controller workload
        # signatures, not regressions — reported so a policy change that
        # triples the action rate is visible, never red.
        # spawn_to_ready_ms (process cold-start + cache loads) swings
        # with host load, and steady_compiles is a warm-scale-up
        # contract count — both reported, never red.
        for info_field, higher in (("compile_ms", False),
                                   ("cold_start_ms", False),
                                   ("prefix_hit_rate", True),
                                   ("spec_accept_rate", True),
                                   ("shard_bytes_max", False),
                                   ("decisions", False),
                                   ("suppressed", False),
                                   ("time_to_recover_s", False),
                                   ("spawn_to_ready_ms", False),
                                   ("steady_compiles", False),
                                   # routing-mode split: a workload
                                   # signature (how often affinity found
                                   # a signal), not a regression axis
                                   ("affinity_route_share", True)):
            c = _check(info_field, _num(fresh_lane, info_field),
                       _num(base_lane, info_field), tolerance, higher)
            if c is not None:
                c["ok"] = True
                c["informational"] = True
                checks.append(c)
        reasons = [
            f"{c['metric']}: {c['fresh']:g} vs baseline "
            f"{c['baseline']:g} (ratio {c['ratio']:g}, "
            f"tolerance {c['tolerance']:g})"
            + (f" — {c['note']}" if c.get("note") else "")
            for c in checks if not c["ok"]]
        status = "red" if reasons else "green"
        if reasons:
            red.append(name)
        lanes[name] = {"status": status, "checks": checks,
                       "reasons": reasons}
    # lanes only in the fresh run have nothing to regress against
    for name in sorted(set(fresh_cfg) - set(base_cfg)):
        lanes[name] = {"status": "skipped",
                       "reasons": ["no baseline lane"]}
        skipped.append(name)
    return {"gate": "bench-regression", "tolerance": tolerance,
            "green": not red, "red": red, "skipped": skipped,
            "lanes": lanes}


def gate(fresh: Dict[str, Any], baseline_path: str,
         tolerance: float = DEFAULT_TOLERANCE) -> Dict[str, Any]:
    """Load the baseline, compare, and return the verdict with the
    baseline path recorded (the bench CLI prints this as its second
    stdout line and exits nonzero unless ``verdict["green"]``)."""
    verdict = compare(fresh, load_baseline(baseline_path),
                      tolerance=tolerance)
    verdict["baseline"] = baseline_path
    return verdict
