"""Counterfactual policy replay over recorded autopilot telemetry.

The port's copy of ``mmlspark_tpu/control/replay.py``.

The autopilot's decision core is a PURE function — ``decide(signals,
policy, state)`` reads no clock and does no I/O — and every live run
records both sides of it: ``autopilot_signals`` events carry the policy
(once) and the full per-tick signal payload, ``autopilot`` events carry
the decisions made. That makes recorded runs replayable offline:

- **Fidelity**: replaying the recorded signals under the recorded
  policy reproduces the recorded decision list *byte for byte* (the
  events satellite's replay-sufficiency promise, now checked by a
  tool instead of asserted in a docstring).
- **Counterfactuals**: replaying the same signals under CANDIDATE
  policies shows what each would have decided, scored by a first-order
  outcome model (below) — turning the 18 hand-tuned ``autopilot.*``
  thresholds into measurable choices. ``mmlspark-tpu-torch autopilot replay``
  prints the ranked comparison.

The counterfactual outcome model is deliberately simple and fully
deterministic: it does NOT re-simulate the fleet. Recorded per-tick shed
deltas and SLO burn are discounted by the capacity ratio
``recorded_live / virtual_live``, where ``virtual_live`` walks the
candidate's actuated scale decisions (so a policy that scales up earlier
is credited with proportionally less shed, one that never scales keeps
the recorded pain). Shift/admission decisions only count against the
action budget. This is a threshold-tuning instrument — rank candidates,
then canary the winner — not a simulator.
"""
from __future__ import annotations

import json
from dataclasses import fields as _dc_fields
from typing import Any, Dict, List, Optional, Sequence

from mmlspark_tpu_torch.control.autopilot import (
    AutopilotPolicy, AutopilotState, advance_state, decide,
)
from mmlspark_tpu_torch.utils.logging import get_logger

logger = get_logger("control.replay")

# decision-event fields added by ACTUATION (not by decide()): stripped
# when reconstructing the recorded decision list from events
_ACTUATION_KEYS = ("replica", "error")


def load_log(paths: Sequence[str]) -> Dict[str, Any]:
    """Parse one or more event JSONL files (per-host/per-pid sidecars
    merge naturally) into the replay inputs::

        {"policy": {field: value} | None,   # autopilot_signals/policy
         "ticks": [signals, ...],           # autopilot_signals/tick
         "decisions": [decision, ...]}      # autopilot events, normalized

    Events are merged across files and ordered by their wall-clock
    ``ts`` (stable for ties, so one file replays in write order).
    Unparseable lines are skipped with a warning — a sidecar truncated
    by a kill must not sink the whole replay.
    """
    rows: List[Dict[str, Any]] = []
    for path in paths:
        with open(path, "r", encoding="utf-8") as fh:
            for lineno, line in enumerate(fh, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    e = json.loads(line)
                except json.JSONDecodeError:
                    logger.warning("%s:%d: skipping unparseable line",
                                   path, lineno)
                    continue
                if isinstance(e, dict) and e.get("type") in (
                        "autopilot", "autopilot_signals"):
                    rows.append(e)
    rows.sort(key=lambda e: float(e.get("ts", 0.0)))
    policy: Optional[Dict[str, Any]] = None
    ticks: List[Dict[str, Any]] = []
    decisions: List[Dict[str, Any]] = []
    for e in rows:
        if e["type"] == "autopilot_signals":
            if e.get("name") == "policy" and policy is None:
                policy = {k: v for k, v in e.items()
                          if k not in ("ts", "type", "name")}
            elif e.get("name") == "tick":
                sig = e.get("signals")
                if isinstance(sig, dict):
                    ticks.append(sig)
        else:
            d = {k: v for k, v in e.items()
                 if k not in ("ts", "type") + _ACTUATION_KEYS}
            d["action"] = d.pop("name")
            decisions.append(d)
    return {"policy": policy, "ticks": ticks, "decisions": decisions}


def policy_from_fields(fields: Dict[str, Any],
                       overrides: Optional[Dict[str, Any]] = None
                       ) -> AutopilotPolicy:
    """Rebuild an :class:`AutopilotPolicy` from a recorded policy event
    (or any field dict), with candidate ``overrides`` applied on top.
    Unknown keys are rejected — a typo'd override must not silently
    replay the recorded threshold."""
    known = {f.name for f in _dc_fields(AutopilotPolicy)}
    vals: Dict[str, Any] = {k: v for k, v in (fields or {}).items()
                            if k in known}
    for k, v in (overrides or {}).items():
        if k not in known:
            raise ValueError(f"unknown policy field {k!r} "
                             f"(known: {sorted(known)})")
        vals[k] = v
    for name in ("min_replicas", "max_replicas", "hbm_limit_bytes",
                 "max_actions_per_window"):
        if name in vals:
            vals[name] = int(vals[name])
    return AutopilotPolicy(**vals)


def parse_overrides(spec: str) -> Dict[str, float]:
    """``"scale_up_queue=2,scale_cooldown_s=10"`` -> field dict (values
    parsed as JSON numbers/bools where possible, strings otherwise)."""
    out: Dict[str, Any] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"override {part!r} is not key=value")
        k, v = part.split("=", 1)
        try:
            out[k.strip()] = json.loads(v.strip())
        except json.JSONDecodeError:
            out[k.strip()] = v.strip()
    return out


def replay_decisions(ticks: Sequence[Dict[str, Any]],
                     policy: AutopilotPolicy) -> List[Dict[str, Any]]:
    """Run the pure decision core over the recorded signal frames under
    ``policy`` on the recorded (virtual) clock. Because the recorded
    frames already embed what the fleet did, replaying the RECORDED
    policy reproduces the recorded decision list exactly."""
    state = AutopilotState()
    out: List[Dict[str, Any]] = []
    for sig in ticks:
        ds = decide(sig, policy, state)
        advance_state(state, ds, sig, window_s=policy.window_s)
        out.extend(ds)
    return out


def fidelity_check(recorded: Sequence[Dict[str, Any]],
                   replayed: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Byte-identical comparison of the recorded vs replayed decision
    lists (canonical ``json.dumps(..., sort_keys=True)`` per decision).
    Returns ``{identical, recorded, replayed, first_diff}``."""
    a = [json.dumps(d, sort_keys=True, default=str) for d in recorded]
    b = [json.dumps(d, sort_keys=True, default=str) for d in replayed]
    first_diff = None
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            first_diff = {"index": i, "recorded": x, "replayed": y}
            break
    if first_diff is None and len(a) != len(b):
        i = min(len(a), len(b))
        first_diff = {"index": i,
                      "recorded": a[i] if i < len(a) else None,
                      "replayed": b[i] if i < len(b) else None}
    return {"identical": a == b, "recorded": len(a), "replayed": len(b),
            "first_diff": first_diff}


def _live_and_shed(ticks: Sequence[Dict[str, Any]]):
    """Per-tick (recorded_live, shed_delta, burn_fast) from the signal
    frames: live = ready replicas, shed deltas from the per-replica
    monotone shed counters."""
    prev_shed: Dict[str, float] = {}
    rows = []
    for sig in ticks:
        reps = sig.get("replicas") or {}
        live = sum(1 for r in reps.values() if r.get("ready"))
        delta = 0.0
        for name, r in reps.items():
            s = float(r.get("shed", 0.0))
            delta += max(0.0, s - prev_shed.get(name, 0.0))
            prev_shed[name] = s
        burn = float((sig.get("slo") or {}).get("burn_fast", 0.0))
        rows.append((live, delta, burn))
    return rows


def score_policy(ticks: Sequence[Dict[str, Any]],
                 policy: AutopilotPolicy) -> Dict[str, Any]:
    """Counterfactual outcome of ``policy`` over the recorded frames.

    ``virtual_live`` starts at the first frame's recorded live count and
    walks the candidate's actuated scale decisions (bounded by the
    candidate's own min/max); each tick's recorded shed delta and SLO
    burn are discounted by ``recorded_live / virtual_live`` — the
    capacity the candidate would have had relative to what the recorded
    run actually had. Lower is better on every score."""
    state = AutopilotState()
    rows = _live_and_shed(ticks)
    virtual = rows[0][0] if rows else 0
    cf_shed = 0.0
    cf_burn = 0.0
    actions = 0
    scale_ups = scale_downs = 0
    for sig, (live, shed_delta, burn) in zip(ticks, rows):
        ds = decide(sig, policy, state)
        advance_state(state, ds, sig, window_s=policy.window_s)
        for d in ds:
            if d.get("suppressed"):
                continue
            actions += 1
            if d["action"] == "scale_up" and virtual < policy.max_replicas:
                virtual += 1
                scale_ups += 1
            elif d["action"] == "scale_down" \
                    and virtual > policy.min_replicas:
                virtual -= 1
                scale_downs += 1
        ratio = live / max(1, virtual)
        cf_shed += shed_delta * ratio
        cf_burn += burn * ratio
    return {"shed": round(cf_shed, 4), "slo_burn": round(cf_burn, 4),
            "actions": actions, "scale_ups": scale_ups,
            "scale_downs": scale_downs,
            "final_virtual_replicas": virtual, "ticks": len(ticks)}


def rank_policies(ticks: Sequence[Dict[str, Any]],
                  candidates: Dict[str, AutopilotPolicy]
                  ) -> List[Dict[str, Any]]:
    """Score every candidate and rank best-first: least counterfactual
    shed, then least SLO burn, then fewest actuations (a quieter
    controller wins ties)."""
    scored = []
    for name, pol in candidates.items():
        s = score_policy(ticks, pol)
        s["policy"] = name
        scored.append(s)
    scored.sort(key=lambda s: (s["shed"], s["slo_burn"], s["actions"],
                               s["policy"]))
    for i, s in enumerate(scored, 1):
        s["rank"] = i
    return scored


def format_ranking(ranked: Sequence[Dict[str, Any]],
                   fidelity: Optional[Dict[str, Any]] = None) -> str:
    """Human-readable ranked comparison (the CLI's output)."""
    lines = []
    if fidelity is not None:
        mark = "OK" if fidelity["identical"] else "MISMATCH"
        lines.append(
            f"fidelity: {mark} — recorded policy replays "
            f"{fidelity['replayed']}/{fidelity['recorded']} decisions "
            f"byte-identical={fidelity['identical']}")
        if fidelity["first_diff"] is not None:
            fd = fidelity["first_diff"]
            lines.append(f"  first diff at decision {fd['index']}:")
            lines.append(f"    recorded: {fd['recorded']}")
            lines.append(f"    replayed: {fd['replayed']}")
    head = (f"{'rank':>4}  {'policy':<24} {'cf_shed':>10} "
            f"{'cf_slo_burn':>12} {'actions':>8} {'up/down':>8}")
    lines.append(head)
    lines.append("-" * len(head))
    for s in ranked:
        lines.append(
            f"{s['rank']:>4}  {s['policy']:<24} {s['shed']:>10.2f} "
            f"{s['slo_burn']:>12.2f} {s['actions']:>8} "
            f"{s['scale_ups']}/{s['scale_downs']:>4}")
    return "\n".join(lines)
