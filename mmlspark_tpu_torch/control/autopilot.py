"""Autopilot: the SLO-driven control loop over the serving fleet.

The port's copy of ``mmlspark_tpu/control/autopilot.py``. The sensors
are the burn-rate :class:`SloEngine`, the replica-labeled
:class:`FleetScraper` and the device :class:`MemoryLedger`; the levers are
``Router.set_weight``, the ``Fleet`` / ``ProcessFleet`` replica lifecycle,
``WeightedFairAdmission`` and the rollout abort. This module closes the loop,
after the design of Google's Autopilot (Rzadca et al., EuroSys 2020) and
the SRE Workbook's multi-window burn-rate alerts:

- **Sense**: one scrape + one SLO observation per evaluation tick, on an
  injectable clock.
- **Decide**: :func:`decide` is a PURE function of ``(signals, policy,
  state)`` — no clock reads, no I/O, no mutation — so every decision is
  unit-testable as a table row and replayable from its event payload.
- **Actuate** five levers: per-replica traffic shift (ramp
  ``Router.set_weight`` down on an error-rate outlier, back on
  recovery), replica scale up/down through ``Fleet`` (bounded by
  ``autopilot.{min,max}_replicas`` and HBM headroom), adaptive admission
  (tighten/relax the ``WeightedFairAdmission`` fleet quota under
  fast-window burn), the rollout guard (abort ``Fleet.rollout`` when
  the canary burns), and the elastic mesh
  (``Fleet.reshard``: widen the tensor axis under HBM-ledger pressure,
  narrow it when queue depth wants replicas the scale lever can no
  longer add; ``autopilot.reshard_*`` keys).
- **Hysteresis is part of the decision core**, not an afterthought:
  separate up/down thresholds per lever, per-lever cooldowns keyed so a
  reversal (A -> B -> A) cannot happen inside one cooldown window, and a
  rolling max-actions budget. The chaos scenario asserts no-flap from
  the event stream alone.

Every decision — actuated OR considered-but-suppressed (cooldown,
actuation-budget window, bounds veto) — is emitted as an ``autopilot``
event with enough payload to replay it, counted in the metrics registry,
and surfaced by ``mmlspark-tpu-torch report`` / ``top``. See
the reference's docs/AUTOPILOT.md for the signal -> lever matrix. Lever
5 actuates ``Fleet.reshard`` (the in-process fleet moves its placements
over the leader's ranks, ``parallel/leader.py``) and the fleet's new
``mesh_shape`` feeds the next tick; a reshard that cannot run
(``ProcessFleet.reshard`` raises, as the reference's does; a mesh
without its ranks; a placement over budget) is recorded with its
``error`` and the lever cools down.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, fields as _dc_fields
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from mmlspark_tpu_torch.observability import events, metrics
from mmlspark_tpu_torch.utils import config as mmlconfig
from mmlspark_tpu_torch.utils.logging import get_logger

logger = get_logger("control.autopilot")


@dataclass(frozen=True)
class AutopilotPolicy:
    """Every threshold the decision function reads, in one frozen value.

    Defaults come from the ``autopilot.*`` config keys
    (:meth:`from_config`); tests construct policies directly. Up/down
    thresholds are deliberately separated per lever — the gap between
    them is the hysteresis band that keeps the controller from chasing
    noise."""

    tick_s: float = 5.0
    min_replicas: int = 1
    max_replicas: int = 8
    hbm_limit_bytes: int = 0
    scale_up_queue: float = 4.0
    scale_down_queue: float = 0.0
    scale_cooldown_s: float = 25.0
    shift_error_rate: float = 0.5
    shift_recover_rate: float = 0.05
    shift_step: float = 0.5
    shift_cooldown_s: float = 20.0
    admission_factor: float = 0.5
    admission_floor_frac: float = 0.25
    admission_relax_burn: float = 1.0
    admission_cooldown_s: float = 25.0
    # fifth lever — elastic mesh: the target placements ('' disables the
    # direction). ``reshard_wide`` is the wider-tensor-axis shape taken
    # under HBM-ledger pressure (per-chip bytes shrink as the tensor axis
    # grows); ``reshard_narrow`` the narrower shape taken when queue
    # depth wants replicas the scale lever can no longer add. Both
    # directions share one cooldown key, so wide -> narrow -> wide
    # cannot flap inside a window (structural hysteresis, like scale).
    reshard_wide: str = ""
    reshard_narrow: str = ""
    reshard_hbm_frac: float = 0.85
    reshard_cooldown_s: float = 60.0
    window_s: float = 120.0
    max_actions_per_window: int = 8

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError("autopilot.min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("autopilot.max_replicas must be >= min")
        if not (0.0 < self.shift_step <= 1.0):
            raise ValueError("autopilot.shift_step must be in (0, 1]")
        if self.shift_recover_rate > self.shift_error_rate:
            raise ValueError("shift_recover_rate must be <= "
                             "shift_error_rate (hysteresis band)")
        if self.scale_down_queue > self.scale_up_queue:
            raise ValueError("scale_down_queue must be <= scale_up_queue "
                             "(hysteresis band)")
        if not (0.0 < self.admission_factor < 1.0):
            raise ValueError("admission_factor must be in (0, 1)")
        if not (0.0 < self.reshard_hbm_frac <= 1.0):
            raise ValueError(
                "reshard_hbm_frac must be in (0, 1]")
        if self.reshard_wide and self.reshard_wide == self.reshard_narrow:
            raise ValueError(
                "reshard_wide and reshard_narrow must name DIFFERENT "
                "shapes (the gap is the hysteresis band)")

    @classmethod
    def from_config(cls, **overrides) -> "AutopilotPolicy":
        kw = {f.name: f.type for f in _dc_fields(cls)}
        vals: Dict[str, Any] = {}
        for name in kw:
            vals[name] = mmlconfig.get(f"autopilot.{name}")
        vals.update(overrides)
        for name in ("min_replicas", "max_replicas", "hbm_limit_bytes",
                     "max_actions_per_window"):
            vals[name] = int(vals[name])
        return cls(**vals)


class AutopilotState:
    """The controller's memory between ticks: previous per-replica
    counters (decisions key on DELTAS, not lifetime totals), last-action
    timestamps per cooldown key, and the rolling actuation deque the
    max-actions window counts over. Mutated only by
    :func:`advance_state` / :meth:`Autopilot._apply` — :func:`decide`
    just reads it."""

    def __init__(self):
        self.prev: Dict[str, Dict[str, float]] = {}
        self.last_action: Dict[str, float] = {}
        self.actions: Deque[Tuple[float, str]] = deque()
        self.ticks = 0


def cooldown_key(lever: str, target: str) -> str:
    """Cooldown bucket for one decision. Scale, admission, and reshard
    are fleet-level (up and down — or wide and narrow — share one key so
    one direction cannot chase the other inside the cooldown); shift and
    everything replica-scoped key per target for the same reason — both
    directions of a lever share its key, which is what makes the no-flap
    property structural."""
    return lever if lever in ("scale", "admission", "reshard") else \
        f"{lever}:{target}"


def _last_name(names) -> str:
    """Deterministic scale-down victim: the highest-numbered replica
    (numeric-aware so ``r10`` sorts after ``r2``)."""
    return max(names, key=lambda n: (len(n), n))


def decide(signals: Dict[str, Any], policy: AutopilotPolicy,
           state: AutopilotState) -> List[Dict[str, Any]]:
    """The pure decision core: ``(signals, policy, state) -> decisions``.

    ``signals`` is the dict :func:`fleet_signals` builds (see there for
    the schema); ``state`` is read, never written. Each decision dict
    carries ``lever``/``action``/``target``/``t``/``suppressed``/
    ``reason`` plus the numeric inputs that produced it — the replay
    payload the events satellite requires. Suppressed decisions are the
    considered-but-held ones: cooldown, actuation-budget window, or a
    bounds veto (max replicas, HBM headroom, admission floor)."""
    now = float(signals["now"])
    decisions: List[Dict[str, Any]] = []
    budget = {"used": sum(1 for (t, _) in state.actions
                          if now - t < policy.window_s)}

    def push(lever: str, action: str, target: str, reason: str,
             cd_s: float, **payload) -> None:
        d: Dict[str, Any] = {"lever": lever, "action": action,
                             "target": target, "t": now,
                             "suppressed": False, "reason": reason}
        d.update(payload)
        key = cooldown_key(lever, target)
        last = state.last_action.get(key)
        if last is not None and now - last < cd_s:
            d["suppressed"] = True
            d["reason"] = (f"cooldown:{key} ({now - last:.0f}s of "
                           f"{cd_s:.0f}s; wanted: {reason})")
        elif budget["used"] >= policy.max_actions_per_window:
            d["suppressed"] = True
            d["reason"] = (f"window:{budget['used']}/"
                           f"{policy.max_actions_per_window} actions in "
                           f"{policy.window_s:.0f}s (wanted: {reason})")
        else:
            budget["used"] += 1
        decisions.append(d)

    def veto(lever: str, action: str, target: str, reason: str,
             **payload) -> None:
        decisions.append({"lever": lever, "action": action,
                          "target": target, "t": now, "suppressed": True,
                          "reason": reason, **payload})

    replicas: Dict[str, Dict[str, Any]] = signals.get("replicas", {})
    slo = signals.get("slo", {})
    burning = bool(slo.get("burning"))
    burn_fast = float(slo.get("burn_fast", 0.0))

    # -- lever 1: traffic shift (per replica, sorted for determinism) ----
    for name in sorted(replicas):
        r = replicas[name]
        prev = state.prev.get(name)
        if prev is None:
            continue        # first sighting: no deltas to judge yet
        dfail = max(0.0, float(r.get("failed", 0.0))
                    - float(prev.get("failed", 0.0)))
        dgood = max(0.0, float(r.get("completed", 0.0))
                    - float(prev.get("completed", 0.0)))
        total = dfail + dgood
        err = dfail / total if total > 0 else 0.0
        weight = float(r.get("weight", 0.0))
        ready = bool(r.get("ready"))
        unhealthy = (not ready) or (total > 0
                                    and err >= policy.shift_error_rate)
        recovered = ready and (total == 0
                               or err <= policy.shift_recover_rate)
        if unhealthy and weight > 0.0:
            new_w = round(max(0.0, weight - policy.shift_step), 6)
            reason = "replica not ready" if not ready else \
                (f"error rate {err:.2f} >= "
                 f"{policy.shift_error_rate:.2f}")
            push("shift", "shift_down", name, reason,
                 policy.shift_cooldown_s, weight=weight,
                 new_weight=new_w, error_rate=round(err, 4))
        elif recovered and weight < 1.0:
            new_w = round(min(1.0, weight + policy.shift_step), 6)
            push("shift", "shift_up", name,
                 f"recovered (error rate {err:.2f} <= "
                 f"{policy.shift_recover_rate:.2f})",
                 policy.shift_cooldown_s, weight=weight,
                 new_weight=new_w, error_rate=round(err, 4))

    # -- lever 2: replica scale ------------------------------------------
    ready_names = sorted(n for n, r in replicas.items() if r.get("ready"))
    live = len(ready_names)
    mean_q = (sum(float(replicas[n].get("queue_depth", 0.0))
                  for n in ready_names) / live) if live else 0.0
    hbm = float(signals.get("memory", {}).get("total_bytes", 0.0))
    scale_payload = dict(live=live, queue_mean=round(mean_q, 3),
                         burn_fast=round(burn_fast, 3),
                         hbm_bytes=int(hbm))

    want_up, up_reason = False, ""
    if live < policy.min_replicas:
        want_up, up_reason = True, (f"live {live} < min "
                                    f"{policy.min_replicas}")
    elif mean_q >= policy.scale_up_queue:
        want_up, up_reason = True, (f"mean queue {mean_q:.1f} >= "
                                    f"{policy.scale_up_queue:.1f}")
    elif burning and mean_q >= max(1.0, policy.scale_up_queue / 2.0):
        want_up, up_reason = True, (f"slo burning (fast {burn_fast:.1f})"
                                    f" with mean queue {mean_q:.1f}")
    if want_up:
        total_reps = len(replicas)
        projected = hbm + (hbm / live if live else 0.0)
        if total_reps >= policy.max_replicas:
            veto("scale", "scale_up", "",
                 f"bounds:max_replicas ({total_reps} >= "
                 f"{policy.max_replicas}; wanted: {up_reason})",
                 **scale_payload)
        elif policy.hbm_limit_bytes > 0 \
                and projected > policy.hbm_limit_bytes:
            veto("scale", "scale_up", "",
                 f"bounds:hbm (projected {int(projected)} > limit "
                 f"{policy.hbm_limit_bytes}; wanted: {up_reason})",
                 **scale_payload)
        else:
            push("scale", "scale_up", "", up_reason,
                 policy.scale_cooldown_s, **scale_payload)
    elif (not burning) and live > policy.min_replicas \
            and mean_q <= policy.scale_down_queue:
        target = _last_name(ready_names)
        push("scale", "scale_down", target,
             f"idle (mean queue {mean_q:.1f} <= "
             f"{policy.scale_down_queue:.1f}, live {live} > min "
             f"{policy.min_replicas})",
             policy.scale_cooldown_s, **scale_payload)

    # -- lever 3: adaptive admission -------------------------------------
    adm = signals.get("admission")
    if adm:
        cap = int(adm.get("capacity_rows", 0))
        baseline = int(adm.get("baseline_rows", cap)) or cap
        floor = max(1, int(baseline * policy.admission_floor_frac))
        adm_payload = dict(capacity_rows=cap, baseline_rows=baseline,
                           burn_fast=round(burn_fast, 3))
        if burning:
            new_cap = max(floor, int(cap * policy.admission_factor))
            if new_cap < cap:
                push("admission", "admission_tighten", "",
                     f"slo burning (fast {burn_fast:.1f})",
                     policy.admission_cooldown_s,
                     new_capacity=new_cap, **adm_payload)
            else:
                veto("admission", "admission_tighten", "",
                     f"bounds:floor (capacity {cap} already at floor "
                     f"{floor})", **adm_payload)
        elif cap < baseline and burn_fast <= policy.admission_relax_burn:
            new_cap = min(baseline,
                          max(cap + 1,
                              int(round(cap / policy.admission_factor))))
            push("admission", "admission_relax", "",
                 f"burn {burn_fast:.2f} <= "
                 f"{policy.admission_relax_burn:.2f}, capacity {cap} < "
                 f"baseline {baseline}",
                 policy.admission_cooldown_s,
                 new_capacity=new_cap, **adm_payload)

    # -- lever 5: elastic mesh (Fleet.reshard) ---------------------------
    # Wide under HBM-ledger pressure (a wider tensor axis shrinks every
    # chip's resident shard); narrow when queue depth wants replicas the
    # scale lever is vetoed from adding. The two triggers are disjoint
    # pressure regimes and both directions share the "reshard" cooldown
    # key, so the controller cannot oscillate placements.
    cur_shape = str(signals.get("mesh", {}).get("shape", ""))
    if policy.reshard_wide or policy.reshard_narrow:
        total_reps = len(replicas)
        mesh_payload = dict(mesh_shape=cur_shape,
                            hbm_bytes=int(hbm), live=live,
                            queue_mean=round(mean_q, 3))
        hbm_pressure = (policy.hbm_limit_bytes > 0
                        and hbm >= policy.reshard_hbm_frac
                        * policy.hbm_limit_bytes)
        queue_pressure = (want_up
                          and total_reps >= policy.max_replicas)
        if hbm_pressure and policy.reshard_wide:
            reason = (f"hbm {int(hbm)} >= {policy.reshard_hbm_frac:.2f}"
                      f" * limit {policy.hbm_limit_bytes}")
            if cur_shape == policy.reshard_wide:
                veto("reshard", "reshard_wide", policy.reshard_wide,
                     f"bounds:at_target ({cur_shape!r}; wanted: "
                     f"{reason})", **mesh_payload)
            else:
                push("reshard", "reshard_wide", policy.reshard_wide,
                     reason, policy.reshard_cooldown_s, **mesh_payload)
        elif queue_pressure and policy.reshard_narrow:
            reason = (f"queue wants replicas past max "
                      f"{policy.max_replicas} (mean queue {mean_q:.1f};"
                      f" wanted: {up_reason})")
            if cur_shape == policy.reshard_narrow:
                veto("reshard", "reshard_narrow", policy.reshard_narrow,
                     f"bounds:at_target ({cur_shape!r}; wanted: "
                     f"{reason})", **mesh_payload)
            else:
                push("reshard", "reshard_narrow", policy.reshard_narrow,
                     reason, policy.reshard_cooldown_s, **mesh_payload)

    return decisions


def fleet_signals(snap: Dict[str, Any],
                  slo_status: List[Dict[str, Any]],
                  router_stats: Dict[str, Any],
                  now: float, *,
                  admission: Optional[Dict[str, int]] = None,
                  mesh_shape: Optional[str] = None
                  ) -> Dict[str, Any]:
    """Distill one scraper snapshot + SLO observation + router stats into
    the flat signal dict :func:`decide` consumes::

        {"now": t,
         "replicas": {name: {ready, weight, queue_depth, inflight,
                             completed, failed, shed}},
         "slo": {"burning": bool, "breaching": bool, "burn_fast": max},
         "memory": {"total_bytes": int},
         "admission": {"capacity_rows": int, "baseline_rows": int},
         "mesh": {"shape": "4x2"}}

    Readiness comes from the scrape (health truth), weight from the
    router (rotation truth) — the two sides of "is this replica taking
    traffic"."""
    rstats = (router_stats or {}).get("replicas", {})
    reps: Dict[str, Dict[str, Any]] = {}
    for name, one in (snap.get("replicas") or {}).items():
        st = one.get("stats") or {}
        reps[name] = {
            "ready": bool(one.get("ready")),
            "live": bool(one.get("live")),
            "weight": float(rstats.get(name, {}).get("weight", 0.0)),
            "queue_depth": float(st.get("queue_depth", 0.0)),
            "inflight": float(st.get("inflight", 0.0)),
            "completed": float(st.get("completed", 0.0)),
            "failed": float(st.get("failed", 0.0)),
            "shed": float(st.get("shed", 0.0)),
        }
    status = slo_status or []
    sig: Dict[str, Any] = {
        "now": float(now),
        "replicas": reps,
        "slo": {
            "burning": any(s.get("burning") or s.get("breaching")
                           for s in status),
            "breaching": any(s.get("breaching") for s in status),
            "burn_fast": max((float(s.get("burn_fast", 0.0))
                              for s in status), default=0.0),
        },
        "memory": {"total_bytes": float(
            (snap.get("memory") or {}).get("total_bytes", 0.0))},
    }
    if admission:
        sig["admission"] = dict(admission)
    if mesh_shape is not None:
        sig["mesh"] = {"shape": str(mesh_shape)}
    return sig


def advance_state(state: AutopilotState, decisions: List[Dict[str, Any]],
                  signals: Dict[str, Any], *,
                  window_s: float) -> None:
    """Commit one tick into ``state``: record actuated decisions against
    their cooldown keys and the rolling budget window, refresh the
    per-replica counter baseline, trim the window. Split out of the
    class so table tests can run decide/advance cycles with no fleet."""
    now = float(signals["now"])
    for d in decisions:
        if d.get("suppressed"):
            continue
        key = cooldown_key(d["lever"], d.get("target", ""))
        state.last_action[key] = now
        state.actions.append((now, key))
    while state.actions and now - state.actions[0][0] >= window_s:
        state.actions.popleft()
    state.prev = {
        name: {"completed": float(r.get("completed", 0.0)),
               "failed": float(r.get("failed", 0.0))}
        for name, r in (signals.get("replicas") or {}).items()}
    state.ticks += 1


class Autopilot:
    """The closed loop: scrape -> SLO observe -> :func:`decide` ->
    actuate + emit, once per tick.

    ``fleet`` is an in-process :class:`~mmlspark_tpu_torch.serve.fleet.Fleet`
    or a process-backed :class:`~mmlspark_tpu_torch.serve.fleet.ProcessFleet`
    (selected by ``autopilot.scale_backend`` in the CLI — same actuator
    surface, real OS workers); scraper/engine/policy/clock are injectable (the chaos scenario and
    tests drive :meth:`tick` on a virtual clock; ``serve --autopilot``
    uses :meth:`start`'s daemon thread). Every decision is emitted as an
    ``autopilot`` event whether actuated or suppressed; actuation
    failures never kill the loop — they mark the decision's event with
    ``error`` and the controller re-evaluates next tick."""

    def __init__(self, fleet, *,
                 scraper=None, engine=None,
                 policy: Optional[AutopilotPolicy] = None,
                 clock: Optional[Callable[[], float]] = None):
        from mmlspark_tpu_torch.observability.aggregate import FleetScraper
        from mmlspark_tpu_torch.observability.slo import SloEngine
        self.fleet = fleet
        self.router = fleet.router
        self.clock = clock if clock is not None else events.wall
        self.scraper = scraper if scraper is not None else \
            FleetScraper(fleet, clock=self.clock)
        self.engine = engine if engine is not None else \
            SloEngine(clock=self.clock)
        self.policy = policy if policy is not None else \
            AutopilotPolicy.from_config()
        self.state = AutopilotState()
        self._counts = {"actions": 0, "suppressed": 0, "errors": 0}
        self._by_action: Dict[str, int] = {}
        self._recent: Deque[Dict[str, Any]] = deque(maxlen=8)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._policy_emitted = False

    def _emit_signals(self, sig: Dict[str, Any]) -> None:
        """Record the replay feed: one ``autopilot_signals``/``policy``
        event per run (the thresholds the recorded decisions were made
        under) and one ``autopilot_signals``/``tick`` event per tick
        (the FULL signal payload :func:`decide` saw). A distinct event
        type from ``autopilot`` on purpose — decision consumers (the
        chaos no-flap check, the report's decision counts) must not see
        signal frames. Together they make ``mmlspark-tpu-torch autopilot
        replay`` exact: decide() is pure, so policy + signals reproduce
        the decision list byte for byte."""
        if not events.recording_enabled():
            return
        if not self._policy_emitted:
            self._policy_emitted = True
            events.emit("autopilot_signals", "policy",
                        **{f.name: getattr(self.policy, f.name)
                           for f in _dc_fields(AutopilotPolicy)})
        events.emit("autopilot_signals", "tick", signals=sig)

    # -- one evaluation tick ---------------------------------------------
    def tick(self) -> List[Dict[str, Any]]:
        """Sense, decide, actuate, record. Returns this tick's decision
        list (actuated and suppressed) for callers that replay or
        assert on it directly."""
        snap = self.scraper.scrape()
        status = self.engine.observe(self.scraper.slo_sample(snap))
        fairness = self.router.fairness
        sig = fleet_signals(
            snap, status, self.router.stats(), float(self.clock()),
            admission={"capacity_rows": int(fairness.capacity_rows),
                       "baseline_rows": int(getattr(
                           fairness, "baseline_rows",
                           fairness.capacity_rows))},
            mesh_shape=str(getattr(self.fleet, "mesh_shape", "")))
        self._emit_signals(sig)
        decisions = decide(sig, self.policy, self.state)
        for d in decisions:
            if not d["suppressed"]:
                self._actuate(d)
            self._record(d)
        advance_state(self.state, decisions, sig,
                      window_s=self.policy.window_s)
        return decisions

    def _actuate(self, d: Dict[str, Any]) -> None:
        try:
            action = d["action"]
            if action in ("shift_down", "shift_up"):
                self.router.set_weight(d["target"], d["new_weight"])
            elif action == "scale_up":
                d["replica"] = self.fleet.scale_up()
            elif action == "scale_down":
                self.fleet.scale_down(d["target"])
            elif action == "admission_tighten" \
                    or action == "admission_relax":
                self.router.fairness.set_capacity(d["new_capacity"])
            elif action in ("reshard_wide", "reshard_narrow"):
                d["report"] = self.fleet.reshard(d["target"])
            else:  # pragma: no cover - decide() and _actuate in lockstep
                raise ValueError(f"unknown action {action!r}")
        except Exception as e:
            # a failed actuation must not kill the loop: the decision
            # stays visible (with the error), cooldown still applies so
            # the controller does not hammer a broken lever, and the
            # next tick re-senses reality
            logger.error("autopilot actuation %s failed: %s",
                         d["action"], e)
            d["error"] = f"{type(e).__name__}: {e}"
            self._counts["errors"] += 1

    def _record(self, d: Dict[str, Any]) -> None:
        kind = "suppressed" if d["suppressed"] else "actions"
        self._counts[kind] += 1
        self._by_action[d["action"]] = \
            self._by_action.get(d["action"], 0) + 1
        self._recent.append(d)
        if metrics.metrics_enabled():
            metrics.counter(f"autopilot.{kind}").inc()
            metrics.counter(f"autopilot.{d['action']}").inc()
        if events.recording_enabled():
            events.emit("autopilot", d["action"],
                        **{k: v for k, v in d.items() if k != "action"})

    # -- rollout guard ----------------------------------------------------
    def rollout_guard(self, replica: str) -> Optional[str]:
        """``Fleet.rollout(guard=...)`` hook: re-sense AFTER the canary
        took traffic on the new version; a burning SLO returns the abort
        reason (rollout raises ``RolloutAborted``), a healthy one
        returns None. Both outcomes are recorded — the hold shows up as
        a suppressed ``rollout_abort`` decision, so a post-mortem can
        see the guard looked and chose not to fire."""
        snap = self.scraper.scrape()
        status = self.engine.observe(self.scraper.slo_sample(snap))
        burning = any(s.get("burning") or s.get("breaching")
                      for s in status)
        burn = max((float(s.get("burn_fast", 0.0)) for s in status),
                   default=0.0)
        reason = (f"canary SLO burning (fast burn {burn:.1f})"
                  if burning else
                  f"hold:canary-healthy (fast burn {burn:.1f})")
        self._record({"lever": "rollout", "action": "rollout_abort",
                      "target": replica, "t": float(self.clock()),
                      "suppressed": not burning, "reason": reason,
                      "burn_fast": round(burn, 3)})
        return reason if burning else None

    # -- observability ----------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """The ``top`` panel / report section source: tick + decision
        counters plus the most recent decisions (action, target,
        suppressed, reason)."""
        return {
            "ticks": self.state.ticks,
            "actions": self._counts["actions"],
            "suppressed": self._counts["suppressed"],
            "errors": self._counts["errors"],
            "by_action": dict(sorted(self._by_action.items())),
            "recent": [{"action": d["action"],
                        "target": d.get("target", ""),
                        "suppressed": bool(d["suppressed"]),
                        "reason": d.get("reason", "")}
                       for d in self._recent],
        }

    # -- background loop --------------------------------------------------
    def start(self) -> None:
        """Tick on a daemon thread every ``policy.tick_s`` until
        :meth:`stop` (the ``serve --autopilot`` mode)."""
        if self._thread is not None:
            return

        def loop() -> None:
            while not self._stop.wait(self.policy.tick_s):
                try:
                    self.tick()
                except Exception:  # pragma: no cover - defensive
                    logger.exception("autopilot tick failed")

        self._stop.clear()
        self._thread = threading.Thread(
            target=loop, name="mmlspark-tpu-torch-autopilot", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None
