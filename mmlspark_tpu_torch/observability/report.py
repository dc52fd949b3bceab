"""Run reports: render a captured events.jsonl into a summary.

The port of ``mmlspark_tpu/observability/report.py``, the offline half of
the telemetry loop (``mmlspark-tpu-torch report <events.jsonl>``): given
the JSON-lines log a run wrote under ``observability.events_path`` (or a
flight-recorder dump, the same schema), :func:`build_report` returns ONE
structured dict (``report --json``) and :func:`render_report` formats it
as text. The sections are the reference's, every one of them, and so are
their keys and text, so a log renders the same through either package:

- per-stage wall time (spans by name: count, total, mean, share of the
  root spans' wall time) and the slowest single spans;
- reliability (retries, fault-site hits, checkpoint quarantines) and
  liveness (watchdog stalls, breaker transitions, preemption, data-state
  quarantines, flight-recorder dumps);
- host syncs (``sync.point`` events by site, ``observability/syncs.py``);
- compile cache, throughput (``train.fit`` / ``train.step``), serving,
  workload (``workload.summary``), generative serving, fleet and rollout,
  memory and the input pipeline (``data.epoch``).

A section whose events a run did not emit is absent, and a section whose
events only the JAX package emits still renders from a log that has
them. Spans are keyed on ``(pid, span_id)``, so merged multi-process
logs never alias two processes' spans. Pure data in, text out: no torch,
no framework state.
"""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Any, Dict, List, Optional

from mmlspark_tpu_torch.observability import metrics
from mmlspark_tpu_torch.utils.logging import get_logger


def load_events(path: str) -> List[Dict[str, Any]]:
    """Parse a JSON-lines event log; malformed lines are counted and
    skipped (a SIGKILLed process tears its final line mid-write), not
    fatal. Every skipped line increments the ``events.torn_lines``
    counter so a merged fleet view quantifies its own data loss."""
    events: List[Dict[str, Any]] = []
    bad = 0
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                bad += 1
    if bad:
        metrics.counter("events.torn_lines").inc(bad)
        get_logger("observability.report").warning(
            "%s: skipped %d torn/malformed line(s)", path, bad)
    return events


def _pct(sorted_vals: List[float], p: float) -> float:
    """Nearest-rank percentile of an ascending list (0 when empty) —
    delegates to the shared estimator in :mod:`..metrics` so report,
    bench and the serve summary agree on the arithmetic."""
    return metrics.nearest_rank(sorted_vals, p)


def _mean(events: List[Dict[str, Any]], field: str) -> float:
    vals = [float(e.get(field, 0.0)) for e in events]
    return sum(vals) / len(vals) if vals else 0.0


def _table(rows: List[List[str]], header: List[str]) -> List[str]:
    widths = [max(len(str(r[i])) for r in [header] + rows)
              for i in range(len(header))]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    lines = [fmt.format(*header), fmt.format(*("-" * w for w in widths))]
    lines.extend(fmt.format(*map(str, r)) for r in rows)
    return lines


def build_report(path, top: int = 10,
                 events: Optional[List[Dict[str, Any]]] = None
                 ) -> Dict[str, Any]:
    """One structured dict with every section of the run report (the
    ``--json`` output). Sections with nothing to say are absent.

    ``path`` may be one event-log path or a list of them (per-pid
    sidecars from a multi-process run): multiple logs are merged into
    one ts-ordered stream; the span sections' ``(pid, span_id)`` dedupe
    already absorbs any overlap."""
    paths = [path] if isinstance(path, str) else list(path)
    if events is None:
        if len(paths) == 1:
            events = load_events(paths[0])
        else:
            from mmlspark_tpu_torch.observability.aggregate import merge_event_logs
            events = merge_event_logs(paths)
    path = paths[0] if len(paths) == 1 else ", ".join(paths)
    spans = [e for e in events if e.get("type") == "span"]
    plain = [e for e in events if e.get("type") == "event"]
    metrics = [e for e in events if e.get("type") == "metric"]

    report: Dict[str, Any] = {
        "path": path,
        "paths": paths,
        "events": len(events),
        "spans": len(spans),
        "metrics": len(metrics),
    }

    # -- per-stage wall time (spans keyed per (pid, span_id)) --------------
    if spans:
        agg: Dict[str, List[float]] = defaultdict(list)
        seen = set()
        for s in spans:
            key = (s.get("pid") or 0, s.get("span_id"))
            if key[1] is not None and key in seen:
                continue               # merged-log duplicate
            seen.add(key)
            agg[s.get("name", "?")].append(float(s.get("dur_s", 0.0)))
        # run wall = sum of root spans; fall back to the span total when the
        # log has no roots (e.g. a filtered or partial capture)
        root_total = sum(float(s.get("dur_s", 0.0)) for s in spans
                         if not s.get("parent_id"))
        denom = root_total or sum(sum(v) for v in agg.values()) or 1.0
        report["stages"] = [
            {"span": name, "count": len(durs), "total_s": round(sum(durs), 6),
             "mean_ms": round(sum(durs) / len(durs) * 1e3, 4),
             "share": round(100.0 * sum(durs) / denom, 2)}
            for name, durs in sorted(agg.items(),
                                     key=lambda kv: -sum(kv[1]))[:top]]
        report["slowest"] = [
            {"span": s.get("name", "?"),
             "dur_s": round(float(s.get("dur_s", 0.0)), 6),
             "depth": s.get("depth", 0), "pid": s.get("pid") or 0,
             "parent": s.get("parent", "") or None}
            for s in sorted(spans,
                            key=lambda s: -float(s.get("dur_s", 0.0)))[:top]]

    # -- reliability -------------------------------------------------------
    retries = [e for e in plain if e.get("name") == "retry.attempt"]
    faults = [e for e in plain if e.get("name") == "fault.hit"]
    quarantines = [e for e in plain
                   if e.get("name") == "checkpoint.quarantine"]
    if retries or faults or quarantines:
        rel: Dict[str, Any] = {}
        if retries:
            by_site: Dict[str, int] = defaultdict(int)
            for e in retries:
                by_site[e.get("policy", "?")] += 1
            rel["retries"] = {"total": len(retries), "by_policy": dict(
                sorted(by_site.items()))}
        if faults:
            by_site = defaultdict(int)
            for e in faults:
                by_site[e.get("site", "?")] += 1
            rel["faults"] = {"total": len(faults),
                             "by_site": dict(sorted(by_site.items()))}
        if quarantines:
            rel["quarantines"] = {"total": len(quarantines),
                                  "steps": [e.get("step")
                                            for e in quarantines]}
        report["reliability"] = rel

    # -- liveness ----------------------------------------------------------
    stalls = [e for e in plain if e.get("name") == "watchdog.stall"]
    trips = [e for e in plain
             if str(e.get("name", "")).startswith("breaker.")]
    preempts = [e for e in plain if e.get("name") == "preemption.signal"]
    drains = [e for e in plain if e.get("name") == "preemption.drain"]
    ds_quar = [e for e in plain
               if e.get("name") == "checkpoint.data_state_quarantine"]
    fdumps = [e for e in plain if e.get("name") == "flightrec.dump"]
    if stalls or trips or preempts or drains or ds_quar or fdumps:
        live: Dict[str, Any] = {}
        if stalls:
            by_hb: Dict[str, int] = defaultdict(int)
            for e in stalls:
                by_hb[e.get("heartbeat", "?")] += 1
            live["stalls"] = {
                "total": len(stalls),
                "by_heartbeat": dict(sorted(by_hb.items())),
                "longest_s": max(float(e.get("stalled_s", 0.0))
                                 for e in stalls)}
        if trips:
            by_key: Dict[str, List[str]] = defaultdict(list)
            for e in trips:
                by_key[e.get("key", "?")].append(
                    str(e.get("name", "")).split(".", 1)[-1])
            live["breakers"] = {
                "transitions": len(trips),
                "opened": sum(1 for e in trips
                              if e.get("name") == "breaker.open"),
                "by_key": dict(sorted(by_key.items()))}
        if preempts or drains:
            live["preemptions"] = {
                "signalled": len(preempts),
                "drains": len(drains),
                "drain_kinds": [
                    {"kind": e.get("kind", "?"), "step": e.get("step")}
                    for e in drains],
                "reasons": sorted({str(e.get("reason", "?"))
                                   for e in preempts + drains})}
        if ds_quar:
            live["data_state_quarantines"] = len(ds_quar)
        if fdumps:
            live["flight_dumps"] = [
                {"reason": e.get("reason", "?"),
                 "events": e.get("events"), "dropped": e.get("dropped")}
                for e in fdumps]
        report["liveness"] = live

    # -- host syncs (observability/syncs.py sync_point events) -------------
    syncs = [e for e in plain if e.get("name") == "sync.point"]
    if syncs:
        by_site: Dict[str, int] = defaultdict(int)
        by_span: Dict[str, int] = defaultdict(int)
        for e in syncs:
            by_site[e.get("site", "?")] += 1
            if e.get("span"):
                by_span[str(e["span"])] += 1
        step_metrics = [m for m in metrics if m.get("name") == "train.step"]
        sec: Dict[str, Any] = {"total": len(syncs),
                               "by_site": dict(sorted(by_site.items()))}
        if by_span:
            sec["by_span"] = dict(sorted(by_span.items()))
        if step_metrics:
            steps = max(int(m.get("step", 0)) for m in step_metrics) or 1
            sec["per_step"] = round(len(syncs) / steps, 4)
        report["syncs"] = sec

    # -- serving -----------------------------------------------------------
    serving = [e for e in events if e.get("type") == "serving"]
    reqs = [e for e in serving if e.get("name") == "request"]
    shed = [e for e in serving if e.get("name") == "shed"]
    expired = [e for e in serving if e.get("name") == "expired"]
    if serving:
        sv: Dict[str, Any] = {}
        if reqs:
            totals = sorted(float(e.get("total_ms", 0.0)) for e in reqs)
            by_model: Dict[str, int] = defaultdict(int)
            for e in reqs:
                by_model[e.get("model", "?")] += 1
            sv["requests"] = {
                "completed": len(reqs),
                "by_model": dict(sorted(by_model.items())),
                "p50_ms": round(_pct(totals, 50), 3),
                "p99_ms": round(_pct(totals, 99), 3),
                "mean_queue_ms": round(_mean(reqs, "queue_ms"), 3),
                "mean_pad_ms": round(_mean(reqs, "pad_ms"), 3),
                "mean_compute_ms": round(_mean(reqs, "compute_ms"), 3),
                "mean_occupancy": round(_mean(reqs, "occupancy"), 4)}
            slow = [e for e in reqs if e.get("slow")]
            if slow:
                sv["slow_traces"] = [
                    {"trace_id": e.get("trace_id"),
                     "total_ms": e.get("total_ms")}
                    for e in sorted(
                        slow, key=lambda e: -float(e.get("total_ms", 0.0))
                    )[:top]]
        offered = len(reqs) + len(shed)
        sv["shed"] = len(shed)
        sv["shed_rate"] = round(
            (100.0 * len(shed) / offered) if offered else 0.0, 2)
        sv["expired"] = len(expired)
        report["serving"] = sv

    # -- workload (open-loop goodput summaries from GoodputMeter.export) ---
    wl_ev = [e for e in events
             if e.get("type") == "workload" and e.get("name") == "summary"]
    if wl_ev:
        lanes = []
        for e in wl_ev:
            lane: Dict[str, Any] = {
                "lane": str(e.get("lane", "") or "-"),
                "offered": int(e.get("offered", 0)),
                "delivered": int(e.get("delivered", 0)),
                "shed": int(e.get("shed", 0)),
                "expired": int(e.get("expired", 0)),
                "goodput": float(e.get("goodput", 0.0)),
                "deadline_ms": float(e.get("deadline_ms", 0.0)),
                "offered_qps": float(e.get("offered_qps", 0.0)),
                "delivered_qps": float(e.get("delivered_qps", 0.0)),
                "arrival_p50_ms": float(e.get("arrival_p50_ms", 0.0)),
                "arrival_p99_ms": float(e.get("arrival_p99_ms", 0.0)),
            }
            worst = e.get("worst_bucket")
            if isinstance(worst, dict):
                lane["worst_bucket"] = {
                    "t0": worst.get("t0"),
                    "p99_ms": worst.get("p99_ms"),
                    "trace_id": worst.get("trace_id")}
            lanes.append(lane)
        report["workload"] = lanes

    # -- generative serving (generate.* + decode.* events) ----------------
    gen_ev = [e for e in events if e.get("type") == "generate"]
    dec_ev = [e for e in events if e.get("type") == "decode"]
    if gen_ev or dec_ev:
        gv: Dict[str, Any] = {}
        greqs = [e for e in gen_ev if e.get("name") == "request"]
        if greqs:
            ttfts = sorted(float(e.get("ttft_ms", 0.0)) for e in greqs)
            itls = sorted(float(e.get("itl_mean_ms", 0.0)) for e in greqs)
            by_model: Dict[str, int] = defaultdict(int)
            for e in greqs:
                by_model[e.get("model", "?")] += 1
            by_finish: Dict[str, int] = defaultdict(int)
            for e in greqs:
                by_finish[str(e.get("finish", "?"))] += 1
            gv["requests"] = {
                "completed": len(greqs),
                "by_model": dict(sorted(by_model.items())),
                "by_finish": dict(sorted(by_finish.items())),
                "tokens": sum(int(e.get("tokens", 0)) for e in greqs),
                "ttft_p50_ms": round(_pct(ttfts, 50), 3),
                "ttft_p99_ms": round(_pct(ttfts, 99), 3),
                "itl_p50_ms": round(_pct(itls, 50), 3),
                "itl_p99_ms": round(_pct(itls, 99), 3),
                "mean_kv_occupancy": round(
                    _mean(greqs, "kv_occupancy"), 4)}
            gv["slow_traces"] = [
                {"trace_id": e.get("trace_id"),
                 "ttft_ms": e.get("ttft_ms")}
                for e in sorted(
                    greqs, key=lambda e: -float(e.get("ttft_ms", 0.0))
                )[:min(top, 3)]]
        gshed = [e for e in gen_ev if e.get("name") == "shed"]
        gv["shed"] = len(gshed)
        gv["expired"] = len([e for e in gen_ev
                             if e.get("name") == "expired"])
        gv["failed_over"] = len([
            e for e in events
            if e.get("type") == "fleet" and e.get("name") == "failover"
            and e.get("kind") == "generate"])
        steps = [e for e in dec_ev if e.get("name") == "step"]
        if steps:
            gv["decode_steps"] = {
                "count": len(steps),
                "mean_active": round(_mean(steps, "active"), 2),
                "mean_step_ms": round(_mean(steps, "step_ms"), 3)}
        pref = [e for e in dec_ev if e.get("name") == "prefix"]
        cows = [e for e in dec_ev if e.get("name") == "cow"]
        if pref or cows:
            hits = sum(int(e.get("hits", 0)) for e in pref)
            misses = sum(int(e.get("misses", 0)) for e in pref)
            gv["prefix_cache"] = {
                "hits": hits, "misses": misses,
                "hit_rate": round(hits / max(1, hits + misses), 4),
                "cached_tokens": sum(int(e.get("cached_tokens", 0))
                                     for e in pref),
                "cow_copies": len(cows)}
        proposed = sum(int(e.get("spec_proposed", 0)) for e in greqs)
        if proposed:
            accepted = sum(int(e.get("spec_accepted", 0)) for e in greqs)
            gv["speculation"] = {
                "proposed": proposed, "accepted": accepted,
                "accept_rate": round(accepted / proposed, 4)}
        quant = [e for e in dec_ev if e.get("name") == "arena"
                 and str(e.get("kv_dtype", "")) == "int8"]
        if quant:
            arena = sum(int(e.get("arena_bytes", 0)) for e in quant)
            gv["int8_kv"] = {
                "arenas": len(quant), "arena_bytes": arena,
                "saved_bytes": sum(int(e.get("unquantized_bytes", 0))
                                   for e in quant) - arena}
        report["generate"] = gv

    # -- fleet (router + rollout) ------------------------------------------
    fleet_ev = [e for e in events if e.get("type") == "fleet"]
    rollout_ev = [e for e in events if e.get("type") == "rollout"]
    if fleet_ev or rollout_ev:
        fl: Dict[str, Any] = {}
        failovers = [e for e in fleet_ev if e.get("name") == "failover"]
        if failovers:
            by_rep: Dict[str, int] = defaultdict(int)
            for e in failovers:
                by_rep[e.get("replica", "?")] += 1
            fl["failovers"] = {"count": len(failovers),
                               "by_replica": dict(sorted(by_rep.items()))}
        all_shed = [e for e in fleet_ev if e.get("name") == "all_shed"]
        if all_shed:
            fl["all_shed"] = len(all_shed)
        throttled = [e for e in fleet_ev
                     if e.get("name") == "tenant_throttled"]
        if throttled:
            by_ten: Dict[str, int] = defaultdict(int)
            for e in throttled:
                by_ten[e.get("tenant", "?")] += 1
            fl["tenant_throttled"] = dict(sorted(by_ten.items()))
        killed = [e.get("replica", "?") for e in fleet_ev
                  if e.get("name") in ("kill", "replica_killed")]
        if killed:
            fl["replicas_killed"] = killed
        if rollout_ev:
            by_target: Dict[Any, Dict[str, Any]] = {}
            for e in rollout_ev:
                key = (e.get("model", "?"), e.get("version", "?"))
                ro = by_target.setdefault(
                    key, {"model": key[0], "version": key[1],
                          "shifted": 0, "warmed": 0, "status": "deploying"})
                if e.get("name") == "shift":
                    ro["shifted"] += 1
                elif e.get("name") == "warm":
                    ro["warmed"] += 1
                elif e.get("name") == "done":
                    ro["status"] = "done"
                elif e.get("name") == "abort":
                    ro["status"] = f"aborted@{e.get('replica', '?')}"
            fl["rollouts"] = list(by_target.values())
        report["fleet"] = fl

    # -- affinity (prefix-digest routing) ----------------------------------
    aff_ev = [e for e in events if e.get("type") == "affinity"]
    if aff_ev:
        routes = [e for e in aff_ev if e.get("name") == "route"]
        af: Dict[str, Any] = {}
        if routes:
            by_mode: Dict[str, int] = defaultdict(int)
            by_rep: Dict[str, int] = defaultdict(int)
            hist: Dict[int, int] = defaultdict(int)
            for e in routes:
                by_mode[e.get("mode", "?")] += 1
                by_rep[e.get("replica", "?")] += 1
                if e.get("mode") == "prefix":
                    hist[int(e.get("depth", 0))] += 1
            n = len(routes)
            af["routes"] = n
            af["by_mode"] = dict(sorted(by_mode.items()))
            af["by_replica"] = dict(sorted(by_rep.items()))
            af["affinity_route_share"] = round(
                (n - by_mode.get("wrr", 0)) / n, 4)
            if hist:
                af["hit_depth_hist"] = {str(k): v for k, v
                                        in sorted(hist.items())}
        adverts = [e for e in aff_ev if e.get("name") == "advertise"]
        if adverts:
            latest: Dict[Any, Dict[str, Any]] = {}
            for e in adverts:    # last write wins: the current digest
                latest[(e.get("replica", "?"), e.get("model", "?"))] = {
                    "replica": e.get("replica", "?"),
                    "model": e.get("model", "?"),
                    "chains": int(e.get("chains", 0)),
                    "max_depth": int(e.get("max_depth", 0))}
            af["advertised"] = sorted(
                latest.values(),
                key=lambda d: (d["replica"], d["model"]))
        report["affinity"] = af

    # -- supervisor (process-fleet restart decisions) ----------------------
    sup_ev = [e for e in events if e.get("type") == "supervisor"]
    if sup_ev:
        sup: Dict[str, Any] = {}
        spawns = [e for e in sup_ev if e.get("name") == "spawn"]
        restarts = [e for e in sup_ev if e.get("name") == "restart"]
        backoffs = [e for e in sup_ev if e.get("name") == "backoff"]
        giveups = [e for e in sup_ev if e.get("name") == "giveup"]
        exits = [e for e in sup_ev if e.get("name") == "exit"]
        by_rep: Dict[str, Dict[str, int]] = defaultdict(
            lambda: {"spawns": 0, "restarts": 0, "backoffs": 0,
                     "giveups": 0})
        for name, evs in (("spawns", spawns), ("restarts", restarts),
                          ("backoffs", backoffs), ("giveups", giveups)):
            for e in evs:
                by_rep[str(e.get("replica", "?"))][name] += 1
        sup["spawns"] = len(spawns)
        sup["restarts"] = len(restarts)
        sup["backoffs"] = len(backoffs)
        sup["giveups"] = len(giveups)
        sup["by_replica"] = {k: dict(v)
                             for k, v in sorted(by_rep.items())}
        sup["worker_pids"] = sorted(
            {int(e["pid"]) for e in spawns
             if e.get("pid") is not None})
        if exits:
            sup["exits"] = [
                {"replica": e.get("replica", "?"), "pid": e.get("pid"),
                 "returncode": e.get("returncode"),
                 "uptime_s": e.get("uptime_s")}
                for e in exits]
        if restarts:
            sup["restart_ready_s_max"] = max(
                float(e.get("ready_s", 0.0)) for e in restarts)
        # elasticity: scale decisions (add_slot/retire) and the
        # spawn->ready latency distribution from the ready events
        adds = [e for e in sup_ev if e.get("name") == "add_slot"]
        retires = [e for e in sup_ev if e.get("name") == "retire"]
        noops = [e for e in sup_ev if e.get("name") == "retire_noop"]
        if adds or retires or noops:
            desired = [int(e["desired"]) for e in adds + retires
                       if e.get("desired") is not None]
            sup["elastic"] = {
                "slots_added": len(adds),
                "slots_retired": len(retires),
                "retire_noops": len(noops),
                "drained": sum(1 for e in retires if e.get("drained")),
                "desired_final": desired[-1] if desired else None,
            }
        ready_ms = sorted(
            float(e["spawn_to_ready_ms"]) for e in sup_ev
            if e.get("name") == "ready"
            and e.get("spawn_to_ready_ms") is not None)
        if ready_ms:
            sup["spawn_to_ready_ms"] = {
                "count": len(ready_ms),
                "p50": round(_pct(ready_ms, 50), 3),
                "p99": round(_pct(ready_ms, 99), 3),
                "max": round(ready_ms[-1], 3),
            }
        shut = [e for e in sup_ev if e.get("name") == "shutdown"]
        if shut:
            sup["shutdowns"] = [
                {"reason": e.get("reason", "?"),
                 "workers": e.get("workers")} for e in shut]
        report["supervisor"] = sup

    # -- SLO burn/breach (slo.* events from the burn-rate engine) ----------
    slo_ev = [e for e in events if e.get("type") == "slo"]
    if slo_ev:
        by_obj: Dict[str, Dict[str, Any]] = {}
        for e in slo_ev:
            o = by_obj.setdefault(
                str(e.get("objective", "?")),
                {"burns": 0, "breaches": 0, "recovers": 0,
                 "max_burn_fast": 0.0})
            name = e.get("name")
            if name == "burn":
                o["burns"] += 1
            elif name == "breach":
                o["breaches"] += 1
            elif name == "recover":
                o["recovers"] += 1
            o["max_burn_fast"] = round(max(
                o["max_burn_fast"], float(e.get("burn_fast", 0.0))), 4)
        report["slo"] = {"events": len(slo_ev),
                         "objectives": dict(sorted(by_obj.items()))}

    # -- autopilot (control-loop decisions: actuated + suppressed) ---------
    ap_ev = [e for e in events if e.get("type") == "autopilot"]
    if ap_ev:
        acted = [e for e in ap_ev if not e.get("suppressed")]
        held = [e for e in ap_ev if e.get("suppressed")]
        by_action: Dict[str, int] = defaultdict(int)
        for e in acted:
            by_action[str(e.get("name", "?"))] += 1
        reasons: Dict[str, int] = defaultdict(int)
        for e in held:
            token = str(e.get("reason", "?")).split()[0] if \
                str(e.get("reason", "")).strip() else "?"
            for prefix in ("cooldown", "window", "hold"):
                if token.startswith(prefix):
                    token = prefix
                    break
            reasons[token] += 1
        report["autopilot"] = {
            "decisions": len(ap_ev),
            "actions": len(acted),
            "suppressed": len(held),
            "by_action": dict(sorted(by_action.items())),
            "suppressed_reasons": dict(sorted(reasons.items())),
            "last": [{"t": e.get("t"), "action": e.get("name", "?"),
                      "target": str(e.get("target", "")),
                      "reason": str(e.get("reason", ""))}
                     for e in acted[-5:]],
        }

    # -- HBM memory (memory.pressure / memory.audit events) ----------------
    mem_ev = [e for e in events if e.get("type") == "memory"]
    if mem_ev:
        pressures = [e for e in mem_ev if e.get("name") == "pressure"]
        audits = [e for e in mem_ev if e.get("name") == "audit"]
        mem: Dict[str, Any] = {}
        if pressures:
            by_model: Dict[str, int] = defaultdict(int)
            freed = 0
            for e in pressures:
                by_model[str(e.get("model", "?"))] += 1
                freed += int(e.get("freed_bytes", 0))
            mem["pressure"] = {"count": len(pressures),
                               "freed_bytes": freed,
                               "by_model": dict(sorted(by_model.items()))}
        if audits:
            last = audits[-1]
            mem["audit"] = {
                "live_bytes": last.get("live_bytes"),
                "accounted_bytes": last.get("accounted_bytes"),
                "unaccounted_bytes": last.get("unaccounted_bytes")}
        if mem:
            report["memory"] = mem

    # -- compile cache (compile_cache.* events) ----------------------------
    cc = [e for e in events if e.get("type") == "compile_cache"]
    if cc:
        by_name: Dict[str, int] = defaultdict(int)
        for e in cc:
            by_name[str(e.get("name", "?"))] += 1
        sec = {"events": len(cc),
               "hits": by_name.get("hit", 0),
               "misses": by_name.get("miss", 0),
               "stores": by_name.get("store", 0),
               "stale": by_name.get("stale", 0),
               "bypasses": by_name.get("bypass", 0),
               "quarantined": by_name.get("quarantine", 0)}
        looked = sec["hits"] + sec["misses"] + sec["stale"]
        sec["hit_rate"] = round(
            (100.0 * sec["hits"] / looked) if looked else 0.0, 2)
        quar = [e for e in cc if e.get("name") == "quarantine"]
        if quar:
            sec["quarantine_reasons"] = sorted(
                {str(e.get("reason", "?")) for e in quar})
        report["compile_cache"] = sec

    # -- throughput --------------------------------------------------------
    fits = [e for e in plain if e.get("name") == "train.fit"]
    step_metrics = [e for e in metrics if e.get("name") == "train.step"]
    if fits or step_metrics:
        th: Dict[str, Any] = {}
        if fits:
            th["fits"] = [
                {"steps": e.get("steps"), "rows": e.get("rows"),
                 "wall_s": e.get("wall_s", 0),
                 "examples_per_sec": e.get("examples_per_sec", 0)}
                for e in fits]
        if step_metrics:
            last = step_metrics[-1]
            rates = [m.get("examples_per_sec", 0.0) for m in step_metrics]
            th["steps"] = {"logged": len(step_metrics),
                           "last_step": last.get("step"),
                           "examples_per_sec_last": rates[-1],
                           "examples_per_sec_max": max(rates)}
        report["throughput"] = th

    # -- input pipeline ----------------------------------------------------
    epochs = [e for e in plain if e.get("name") == "data.epoch"]
    if epochs:
        report["input_pipeline"] = [
            {"epoch": e.get("epoch"), "items": int(e.get("items", 0)),
             "wall_s": float(e.get("wall_s", 0.0))}
            for e in epochs]

    # -- bench results -----------------------------------------------------
    bench = [e for e in plain if e.get("name") == "bench.config"]
    if bench:
        report["bench"] = [
            {"config": e.get("config", "?"), **(e.get("result") or {})}
            for e in bench]

    return report


def render_report(path, top: int = 10) -> str:
    """The full text report for one event log (or a list of per-pid
    sidecar logs, merged)."""
    r = build_report(path, top=top)
    out: List[str] = [f"run report: {r['path']}",
                      f"{r['events']} events "
                      f"({r['spans']} spans, {r['metrics']} metrics)", ""]
    if len(r.get("paths", ())) > 1:
        out.insert(1, f"merged from {len(r['paths'])} event log(s)")

    if "stages" in r:
        rows = [[s["span"], s["count"], f"{s['total_s']:.4f}",
                 f"{s['mean_ms']:.2f}", f"{s['share']:.1f}%"]
                for s in r["stages"]]
        out.append("per-stage wall time:")
        out.extend(_table(rows, ["span", "count", "total_s", "mean_ms",
                                 "share"]))
        out.append("")
        rows = [[s["span"], f"{s['dur_s']:.4f}", s["depth"],
                 s["parent"] or "-"] for s in r["slowest"]]
        out.append("slowest spans:")
        out.extend(_table(rows, ["span", "dur_s", "depth", "parent"]))
        out.append("")

    if "reliability" in r:
        rel = r["reliability"]
        out.append("reliability:")
        if "retries" in rel:
            detail = ", ".join(f"{k}={v}" for k, v in
                               rel["retries"]["by_policy"].items())
            out.append(f"  retry attempts: {rel['retries']['total']} "
                       f"({detail})")
        if "faults" in rel:
            detail = ", ".join(f"{k}={v}" for k, v in
                               rel["faults"]["by_site"].items())
            out.append(f"  fault hits: {rel['faults']['total']} ({detail})")
        if "quarantines" in rel:
            out.append(f"  checkpoint quarantines: "
                       f"{rel['quarantines']['total']} "
                       f"(steps {rel['quarantines']['steps']})")
        out.append("")

    if "liveness" in r:
        live = r["liveness"]
        out.append("liveness:")
        if "stalls" in live:
            detail = ", ".join(f"{k}={v}" for k, v in
                               live["stalls"]["by_heartbeat"].items())
            out.append(f"  watchdog stalls: {live['stalls']['total']} "
                       f"({detail}); longest "
                       f"{live['stalls']['longest_s']:.1f}s "
                       "(stacks in the event log)")
        if "breakers" in live:
            detail = ", ".join(f"{k}: {'->'.join(v)}" for k, v in
                               live["breakers"]["by_key"].items())
            out.append(f"  breaker transitions: "
                       f"{live['breakers']['transitions']} "
                       f"({live['breakers']['opened']} trips to open) "
                       f"[{detail}]")
        if "preemptions" in live:
            pre = live["preemptions"]
            kinds = ", ".join(
                f"{d['kind']}@step {d['step']}" if d["step"] is not None
                else str(d["kind"]) for d in pre["drain_kinds"])
            out.append(f"  preemptions: {pre['signalled']} signalled, "
                       f"{pre['drains']} clean drains"
                       + (f" ({kinds})" if kinds else "")
                       + (f"; reasons: {', '.join(pre['reasons'])}"
                          if pre["reasons"] else ""))
        if "data_state_quarantines" in live:
            out.append(f"  data-state sidecars quarantined: "
                       f"{live['data_state_quarantines']}")
        if "flight_dumps" in live:
            detail = ", ".join(f"{d['reason']} ({d['events']} events)"
                               for d in live["flight_dumps"])
            out.append(f"  flight-recorder dumps: "
                       f"{len(live['flight_dumps'])} [{detail}]")
        out.append("")

    if "syncs" in r:
        sy = r["syncs"]
        out.append("host syncs:")
        detail = ", ".join(f"{k}={v}" for k, v in sy["by_site"].items())
        line = f"  sync points: {sy['total']} ({detail})"
        if "per_step" in sy:
            line += f"; per train step: {sy['per_step']:.2f}"
        out.append(line)
        if "by_span" in sy:
            detail = ", ".join(f"{k}={v}" for k, v in sy["by_span"].items())
            out.append(f"  by span: {detail}")
        out.append("")

    if "serving" in r:
        sv = r["serving"]
        out.append("serving:")
        if "requests" in sv:
            rq = sv["requests"]
            detail = ", ".join(f"{k}={v}"
                               for k, v in rq["by_model"].items())
            out.append(
                f"  requests: {rq['completed']} completed ({detail}); "
                f"latency p50={rq['p50_ms']:.3f}ms "
                f"p99={rq['p99_ms']:.3f}ms")
            out.append(
                f"  mean split: queue={rq['mean_queue_ms']:.3f}ms "
                f"pad={rq['mean_pad_ms']:.3f}ms "
                f"compute={rq['mean_compute_ms']:.3f}ms; "
                f"batch occupancy mean={rq['mean_occupancy']:.2f}")
        if sv.get("slow_traces"):
            detail = ", ".join(f"{t['trace_id']} ({t['total_ms']}ms)"
                               for t in sv["slow_traces"][:3])
            out.append(f"  slow traces (tail-sampled): "
                       f"{len(sv['slow_traces'])} [{detail}]")
        out.append(f"  shed: {sv['shed']} ({sv['shed_rate']:.1f}% of "
                   f"offered), expired: {sv['expired']}")
        out.append("")

    if "workload" in r:
        out.append("workload (open-loop, latency from intended arrival):")
        for wl in r["workload"]:
            out.append(
                f"  [{wl['lane']}] offered {wl['offered']} "
                f"({wl['offered_qps']:.2f} qps), delivered "
                f"{wl['delivered']} ({wl['delivered_qps']:.2f} qps); "
                f"goodput {wl['goodput'] * 100:.1f}% under "
                f"{wl['deadline_ms']:.0f}ms deadline")
            out.append(
                f"    shed {wl['shed']}, expired {wl['expired']}; "
                f"arrival p50={wl['arrival_p50_ms']:.1f}ms "
                f"p99={wl['arrival_p99_ms']:.1f}ms (un-clipped)")
            worst = wl.get("worst_bucket")
            if worst and worst.get("p99_ms") is not None:
                line = (f"    worst bucket @t={worst['t0']:.0f}s: "
                        f"p99={worst['p99_ms']:.1f}ms")
                if worst.get("trace_id"):
                    line += f" (trace {worst['trace_id']})"
                out.append(line)
        out.append("")

    if "generate" in r:
        gv = r["generate"]
        out.append("generative serving:")
        if "requests" in gv:
            rq = gv["requests"]
            detail = ", ".join(f"{k}={v}"
                               for k, v in rq["by_model"].items())
            finish = ", ".join(f"{k}={v}"
                               for k, v in rq["by_finish"].items())
            out.append(
                f"  requests: {rq['completed']} completed ({detail}); "
                f"{rq['tokens']} tokens [{finish}]")
            out.append(
                f"  TTFT p50={rq['ttft_p50_ms']:.3f}ms "
                f"p99={rq['ttft_p99_ms']:.3f}ms; "
                f"ITL p50={rq['itl_p50_ms']:.3f}ms "
                f"p99={rq['itl_p99_ms']:.3f}ms; "
                f"KV occupancy mean={rq['mean_kv_occupancy']:.2f}")
        if gv.get("slow_traces"):
            detail = ", ".join(f"{t['trace_id']} ({t['ttft_ms']}ms)"
                               for t in gv["slow_traces"])
            out.append(f"  slowest TTFT traces: [{detail}]")
        out.append(f"  shed: {gv['shed']}, expired: {gv['expired']}, "
                   f"failed over (restarted): {gv['failed_over']}")
        if "decode_steps" in gv:
            ds = gv["decode_steps"]
            out.append(
                f"  decode steps: {ds['count']} "
                f"(mean active={ds['mean_active']:.2f}, "
                f"mean step={ds['mean_step_ms']:.3f}ms)")
        if "prefix_cache" in gv:
            pc = gv["prefix_cache"]
            out.append(
                f"  prefix cache: {pc['hit_rate'] * 100:.1f}% hit "
                f"({pc['hits']}/{pc['hits'] + pc['misses']} blocks, "
                f"{pc['cached_tokens']} prompt tokens reused, "
                f"{pc['cow_copies']} CoW copies)")
        if "speculation" in gv:
            sp = gv["speculation"]
            out.append(
                f"  speculation: {sp['accept_rate'] * 100:.1f}% accepted "
                f"({sp['accepted']}/{sp['proposed']} draft tokens)")
        if "int8_kv" in gv:
            q = gv["int8_kv"]
            out.append(
                f"  int8 KV: {q['arenas']} arena(s), "
                f"{q['arena_bytes'] / 1e6:.1f}MB stored, "
                f"{q['saved_bytes'] / 1e6:.1f}MB saved vs fp")
        out.append("")

    if "fleet" in r:
        fl = r["fleet"]
        out.append("fleet:")
        if "failovers" in fl:
            detail = ", ".join(f"{k}={v}"
                               for k, v in fl["failovers"]["by_replica"]
                               .items())
            out.append(f"  failovers: {fl['failovers']['count']} "
                       f"({detail})")
        if fl.get("replicas_killed"):
            out.append("  replicas killed: "
                       + ", ".join(fl["replicas_killed"]))
        if "all_shed" in fl:
            out.append(f"  fleet-wide sheds (all replicas full): "
                       f"{fl['all_shed']}")
        if "tenant_throttled" in fl:
            detail = ", ".join(f"{k}={v}"
                               for k, v in fl["tenant_throttled"].items())
            out.append(f"  tenant throttled: {detail}")
        for ro in fl.get("rollouts", ()):
            out.append(
                f"  rollout {ro['model']} -> {ro['version']}: "
                f"{ro['shifted']} replica(s) shifted, "
                f"{ro['warmed']} warmed, {ro['status']}")
        out.append("")

    if "affinity" in r:
        af = r["affinity"]
        out.append("affinity (prefix-digest routing):")
        if "routes" in af:
            detail = ", ".join(f"{k}={v}"
                               for k, v in af["by_mode"].items())
            out.append(f"  routes: {af['routes']} ({detail}; "
                       f"affinity share "
                       f"{af['affinity_route_share'] * 100:.1f}%)")
            detail = ", ".join(f"{k}={v}"
                               for k, v in af["by_replica"].items())
            out.append(f"  by replica: {detail}")
        if "hit_depth_hist" in af:
            detail = ", ".join(f"depth {k}: {v}" for k, v in
                               af["hit_depth_hist"].items())
            out.append(f"  expected hit depth: {detail}")
        for ad in af.get("advertised", ()):
            out.append(
                f"  advertised {ad['replica']}/{ad['model']}: "
                f"{ad['chains']} chain(s), max depth {ad['max_depth']}")
        out.append("")

    if "supervisor" in r:
        sup = r["supervisor"]
        out.append("supervisor:")
        detail = ", ".join(
            f"{k}: {v['spawns']} spawn(s), {v['restarts']} restart(s), "
            f"{v['backoffs']} backoff(s), {v['giveups']} giveup(s)"
            for k, v in sup["by_replica"].items())
        out.append(f"  replicas: {detail}")
        out.append(
            f"  worker pids: "
            f"{', '.join(str(p) for p in sup['worker_pids']) or '-'}")
        for e in sup.get("exits", ()):
            out.append(
                f"  exit: {e['replica']} pid={e['pid']} "
                f"rc={e['returncode']} after {e['uptime_s']}s")
        if "restart_ready_s_max" in sup:
            out.append(f"  slowest restart to ready: "
                       f"{sup['restart_ready_s_max']:.2f}s")
        if "elastic" in sup:
            el = sup["elastic"]
            line = (f"  elastic: {el['slots_added']} slot(s) added, "
                    f"{el['slots_retired']} retired "
                    f"({el['drained']} drained cleanly)")
            if el["retire_noops"]:
                line += f", {el['retire_noops']} retire no-op(s)"
            if el["desired_final"] is not None:
                line += f"; desired now {el['desired_final']}"
            out.append(line)
        if "spawn_to_ready_ms" in sup:
            h = sup["spawn_to_ready_ms"]
            out.append(
                f"  spawn->ready: p50 {h['p50']:.0f}ms, "
                f"p99 {h['p99']:.0f}ms, max {h['max']:.0f}ms "
                f"over {h['count']} spawn(s)")
        for s in sup.get("shutdowns", ()):
            out.append(f"  shutdown ({s['reason']}): "
                       f"{s['workers']} worker(s) drained")
        out.append("")

    if "slo" in r:
        out.append("slo:")
        for name, o in r["slo"]["objectives"].items():
            out.append(
                f"  {name}: {o['burns']} burn(s), "
                f"{o['breaches']} breach(es), {o['recovers']} recover(s); "
                f"max fast burn {o['max_burn_fast']:.2f}x budget")
        out.append("")

    if "autopilot" in r:
        ap = r["autopilot"]
        out.append("autopilot:")
        detail = ", ".join(f"{k}={v}" for k, v in ap["by_action"].items())
        out.append(f"  decisions: {ap['decisions']} "
                   f"({ap['actions']} actuated, "
                   f"{ap['suppressed']} suppressed)"
                   + (f"; actions: {detail}" if detail else ""))
        if ap["suppressed_reasons"]:
            detail = ", ".join(f"{k}={v}" for k, v in
                               ap["suppressed_reasons"].items())
            out.append(f"  suppressed: {detail}")
        for d in ap.get("last", ()):
            tgt = f" {d['target']}" if d["target"] else ""
            out.append(f"  {d['action']}{tgt}: {d['reason']}")
        out.append("")

    if "memory" in r:
        mem = r["memory"]
        out.append("hbm memory:")
        if "pressure" in mem:
            detail = ", ".join(f"{k}={v}" for k, v in
                               mem["pressure"]["by_model"].items())
            out.append(
                f"  pressure evictions: {mem['pressure']['count']} "
                f"({detail}); {mem['pressure']['freed_bytes']} bytes freed")
        if "audit" in mem:
            a = mem["audit"]
            out.append(
                f"  last audit: {a.get('live_bytes')} live, "
                f"{a.get('accounted_bytes')} accounted, "
                f"{a.get('unaccounted_bytes')} unaccounted")
        out.append("")

    if "compile_cache" in r:
        cc = r["compile_cache"]
        out.append("compile cache:")
        out.append(
            f"  lookups: {cc['hits']} hit(s), {cc['misses']} miss(es), "
            f"{cc['stale']} stale ({cc['hit_rate']:.1f}% hit rate); "
            f"{cc['stores']} store(s), {cc['bypasses']} bypass(es)")
        if cc.get("quarantined"):
            reasons = "; ".join(cc.get("quarantine_reasons", ()))
            out.append(f"  quarantined entries: {cc['quarantined']}"
                       + (f" [{reasons}]" if reasons else ""))
        out.append("")

    if "throughput" in r:
        th = r["throughput"]
        out.append("throughput:")
        for e in th.get("fits", ()):
            out.append(
                f"  train.fit: {e['steps'] if e['steps'] is not None else '?'}"
                f" steps, {e['rows'] if e['rows'] is not None else '?'} rows"
                f" in {e['wall_s']:.3f}s "
                f"({e['examples_per_sec']:.1f} examples/sec)")
        if "steps" in th:
            st = th["steps"]
            out.append(
                f"  train.step: {st['logged']} logged steps, last "
                f"step {st['last_step'] if st['last_step'] is not None else '?'}, "
                f"examples/sec last={st['examples_per_sec_last']:.1f} "
                f"max={st['examples_per_sec_max']:.1f}")
        out.append("")

    if "input_pipeline" in r:
        out.append("input pipeline:")
        for e in r["input_pipeline"]:
            rate = e["items"] / e["wall_s"] if e["wall_s"] > 0 else 0.0
            out.append(f"  epoch {e['epoch'] if e['epoch'] is not None else '?'}: "
                       f"{e['items']} items in "
                       f"{e['wall_s']:.3f}s ({rate:.1f} items/sec)")
        out.append("")

    if "bench" in r:
        rows = [[b.get("config", "?"), b.get("value", "-"),
                 b.get("unit", "-"), b.get("vs_baseline", "-")]
                for b in r["bench"]]
        out.append("bench configs:")
        out.extend(_table(rows, ["config", "value", "unit", "vs_baseline"]))
        out.append("")

    if len(out) == 3:  # only the header: nothing recognizable in the log
        out.append("no spans, reliability events, or throughput records "
                   "found")
    return "\n".join(out).rstrip() + "\n"
