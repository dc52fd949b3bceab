"""The port's control plane and load tooling against the JAX package's.

``control/{autopilot,replay}.py``, ``observability/{slo,goodput}.py`` and
``testing/loadgen.py`` are pure host logic copied from the reference, so on
the same inputs their outputs must be EQUAL: ``decide()`` over the
reference's decision table and a seeded fuzz of 500 signal frames (the
reshard lever off and on), ``fleet_signals``, ``SloEngine.observe`` over a
seeded sample stream, ``GoodputMeter.export``, ``loadgen.generate``
fingerprints for every trace shape, the open- and closed-loop simulators,
``replay_decisions`` / ``rank_policies``, and the two CLIs' ``loadgen`` and
``autopilot replay`` JSON. The port's ``Autopilot`` then drives an
in-process CPU ``Fleet``: it scales out and back with scores equal to one
``Server``, a reshard decision is actuated into ``Fleet.reshard`` (which
raises in the port) and recorded with its ``error``, and the log it records
replays identically under the REFERENCE's replay. The config test holds the
port's ``_DEFAULTS`` to the reference's on every shared key.
"""
import dataclasses
import json
import random

import numpy as np
import pytest

from mmlspark_tpu import cli as jcli
from mmlspark_tpu.control import autopilot as jap
from mmlspark_tpu.control import replay as jrp
from mmlspark_tpu.observability import events as jevents
from mmlspark_tpu.observability import goodput as jgoodput
from mmlspark_tpu.observability import slo as jslo
from mmlspark_tpu.testing import loadgen as jloadgen
from mmlspark_tpu.utils import config as jconfig
from mmlspark_tpu_torch import cli as tcli
from mmlspark_tpu_torch.control import autopilot as tap
from mmlspark_tpu_torch.control import replay as trp
from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.observability import events as tevents
from mmlspark_tpu_torch.observability import goodput as tgoodput
from mmlspark_tpu_torch.observability import metrics as tmetrics
from mmlspark_tpu_torch.observability import slo as tslo
from mmlspark_tpu_torch.serve import Fleet, Server
from mmlspark_tpu_torch.testing import loadgen as tloadgen
from mmlspark_tpu_torch.utils import config as tconfig


def _canon(x):
    return json.loads(json.dumps(x, sort_keys=True, default=str))


# -- config ---------------------------------------------------------------------

def test_config_defaults_equal_the_reference_on_every_shared_key():
    shared = set(jconfig._DEFAULTS) & set(tconfig._DEFAULTS)
    for key in sorted(shared):
        want, got = jconfig._DEFAULTS[key], tconfig._DEFAULTS[key]
        assert got == want and type(got) is type(want), key
    # the port's own keys: its device, its torch.distributed backend, and
    # the bound of the meshed serving channel's transfers
    assert set(tconfig._DEFAULTS) - set(jconfig._DEFAULTS) == \
        {"runtime.device", "runtime.dist_backend", "runtime.mesh_timeout_s"}
    for ns in ("slo.", "autopilot.", "fleet.supervisor_"):
        keys = {k for k in jconfig._DEFAULTS if k.startswith(ns)}
        assert keys and keys <= set(tconfig._DEFAULTS), ns
    for key in ("fleet.devices_per_worker", "fleet.hosts",
                "observability.memory_poll_s",
                "reliability.stall_timeout_s"):
        assert key in tconfig._DEFAULTS


def test_policy_from_config_equals_the_reference():
    assert dataclasses.asdict(tap.AutopilotPolicy.from_config()) == \
        dataclasses.asdict(jap.AutopilotPolicy.from_config())
    assert tap.AutopilotPolicy.from_config(max_replicas=3).max_replicas == 3


# -- decide(): the reference table and a seeded fuzz ----------------------------

def rep(ready=True, weight=1.0, q=0.0, completed=0.0, failed=0.0):
    return {"ready": ready, "live": ready, "weight": weight,
            "queue_depth": q, "inflight": 0.0,
            "completed": completed, "failed": failed, "shed": 0.0}


def sig(now=1000.0, replicas=None, burning=False, burn_fast=0.0,
        hbm=0.0, admission=None, mesh=None):
    s = {"now": now, "replicas": replicas or {},
         "slo": {"burning": burning, "breaching": False,
                 "burn_fast": burn_fast},
         "memory": {"total_bytes": hbm}}
    if admission:
        s["admission"] = admission
    if mesh is not None:
        s["mesh"] = {"shape": mesh}
    return s


POLICY = dict(
    tick_s=30.0, min_replicas=1, max_replicas=4,
    scale_up_queue=4.0, scale_down_queue=0.0, scale_cooldown_s=60.0,
    shift_error_rate=0.5, shift_recover_rate=0.05, shift_step=0.5,
    shift_cooldown_s=40.0, admission_factor=0.5,
    admission_floor_frac=0.25, admission_relax_burn=1.0,
    admission_cooldown_s=60.0, window_s=300.0, max_actions_per_window=8)
RESHARD = dict(max_replicas=2, hbm_limit_bytes=1000, reshard_wide="2x4",
               reshard_narrow="4x2", reshard_hbm_frac=0.85,
               reshard_cooldown_s=120.0)
CAP = {"capacity_rows": 24, "baseline_rows": 24}
PREV_BURN = {"r0": {"completed": 10.0, "failed": 0.0},
             "r1": {"completed": 10.0, "failed": 0.0}}

# name -> (policy kwargs, initial state.prev, frames decided and advanced
# in turn): the frames of the reference's decision-table tests
TABLE = {
    "queue_pressure_scales_up": (POLICY, None, [
        sig(replicas={"r0": rep(q=6.0), "r1": rep(q=4.0)})]),
    "scale_cooldown": (POLICY, None, [
        sig(now=1000.0, replicas={"r0": rep(q=6.0)}),
        sig(now=1030.0, replicas={"r0": rep(q=6.0), "r1": rep(q=6.0)}),
        sig(now=1060.0, replicas={"r0": rep(q=6.0), "r1": rep(q=6.0)})]),
    "action_budget_window": (
        dict(max_actions_per_window=1, window_s=300.0), None, [
            sig(replicas={"r0": rep(q=9.0)}, burning=True, burn_fast=20.0,
                admission=CAP)]),
    "max_replicas_veto": (dict(min_replicas=1, max_replicas=2), None, [
        sig(replicas={"r0": rep(q=9.0), "r1": rep(q=9.0)})]),
    "hbm_headroom_veto": (dict(max_replicas=8, hbm_limit_bytes=1000), None, [
        sig(replicas={"r0": rep(q=9.0), "r1": rep(q=9.0)}, hbm=900.0)]),
    "repair_below_min": (dict(min_replicas=3, max_replicas=6), None, [
        sig(replicas={"r0": rep(), "r1": rep(), "r2": rep(ready=False)})]),
    "idle_scale_down_victim": (POLICY, None, [
        sig(replicas={"r2": rep(), "r10": rep(), "r9": rep()})]),
    "burn_shift_and_tighten": (POLICY, PREV_BURN, [
        sig(replicas={"r0": rep(completed=20.0, failed=0.0),
                      "r1": rep(completed=10.0, failed=8.0)},
            burning=True, burn_fast=15.0, admission=CAP)]),
    "admission_floor_veto": (POLICY, None, [
        sig(burning=True, burn_fast=20.0,
            admission={"capacity_rows": 6, "baseline_rows": 24})]),
    "admission_relax": (POLICY, None, [
        sig(burning=False, burn_fast=0.2,
            admission={"capacity_rows": 6, "baseline_rows": 24})]),
    "shift_reversal_cooldown": (
        POLICY, {"r0": {"completed": 0.0, "failed": 0.0}}, [
            sig(now=1000.0, replicas={"r0": rep(completed=1.0, failed=9.0)}),
            sig(now=1010.0, replicas={"r0": rep(weight=0.5, completed=21.0,
                                                failed=9.0)}),
            sig(now=1040.0, replicas={"r0": rep(weight=0.5, completed=41.0,
                                                failed=9.0)})]),
    "reshard_wide_under_hbm": (RESHARD, None, [
        sig(replicas={"r0": rep()}, hbm=900.0, mesh="4x2")]),
    "reshard_at_target_veto": (RESHARD, None, [
        sig(replicas={"r0": rep()}, hbm=900.0, mesh="2x4")]),
    "reshard_narrow_past_max": (RESHARD, None, [
        sig(replicas={"r0": rep(q=9.0), "r1": rep(q=9.0)}, mesh="2x4")]),
    "reshard_shared_cooldown": (RESHARD, None, [
        sig(now=1000.0, replicas={"r0": rep()}, hbm=900.0, mesh="4x2"),
        sig(now=1030.0, replicas={"r0": rep(q=9.0), "r1": rep(q=9.0)},
            mesh="2x4"),
        sig(now=1130.0, replicas={"r0": rep(q=9.0), "r1": rep(q=9.0)},
            mesh="2x4")]),
    "reshard_disabled": (POLICY, None, [
        sig(replicas={"r0": rep(q=9.0)}, hbm=99999.0, mesh="4x2")]),
}


def _decide_all(mod, policy_kw, prev, frames):
    policy = mod.AutopilotPolicy(**policy_kw)
    st = mod.AutopilotState()
    if prev:
        st.prev = json.loads(json.dumps(prev))
    out = []
    for s in frames:
        ds = mod.decide(json.loads(json.dumps(s)), policy, st)
        mod.advance_state(st, ds, s, window_s=policy.window_s)
        out.append(ds)
    return out, {"last_action": dict(st.last_action),
                 "actions": list(st.actions), "ticks": st.ticks,
                 "prev": st.prev}


@pytest.mark.parametrize("case", sorted(TABLE))
def test_decide_table_equals_the_reference(case):
    policy_kw, prev, frames = TABLE[case]
    got = _decide_all(tap, policy_kw, prev, frames)
    want = _decide_all(jap, policy_kw, prev, frames)
    assert _canon(got) == _canon(want)
    assert any(got[0])                       # every row decides something
    if case == "reshard_wide_under_hbm":
        (d,) = [d for d in got[0][0] if d["lever"] == "reshard"]
        assert d["action"] == "reshard_wide" and not d["suppressed"]


def _fuzz_frames(seed, n, mesh):
    rng = random.Random(seed)
    now, completed, failed = 1000.0, [0.0] * 3, [0.0] * 3
    frames = []
    for _ in range(n):
        for i in range(3):
            completed[i] += rng.randint(0, 20)
            failed[i] += rng.randint(0, 6)
        frames.append(sig(
            now=now,
            replicas={f"r{i}": rep(
                ready=rng.random() > 0.1,
                weight=rng.choice([0.0, 0.5, 1.0]),
                q=rng.uniform(0.0, 8.0),
                completed=completed[i], failed=failed[i])
                for i in range(3)},
            burning=rng.random() < 0.4, burn_fast=rng.uniform(0.0, 30.0),
            hbm=rng.uniform(0.0, 1200.0),
            admission={"capacity_rows": rng.choice([6, 12, 24]),
                       "baseline_rows": 24},
            mesh=rng.choice(["4x2", "2x4"]) if mesh else None))
        now += rng.choice([10.0, 30.0, 50.0])
    return frames


@pytest.mark.parametrize("lever5", ["off", "on"])
def test_decide_fuzz_500_frames_equals_the_reference(lever5):
    policy_kw = dict(POLICY, hbm_limit_bytes=1000)
    if lever5 == "on":
        policy_kw.update(reshard_wide="2x4", reshard_narrow="4x2",
                         reshard_cooldown_s=90.0)
    frames = _fuzz_frames(11, 500, mesh=lever5 == "on")
    got = _decide_all(tap, policy_kw, None, frames)
    want = _decide_all(jap, policy_kw, None, frames)
    assert _canon(got) == _canon(want)
    levers = {d["lever"] for ds in got[0] for d in ds}
    assert ("reshard" in levers) == (lever5 == "on")
    assert {"scale", "shift", "admission"} <= levers


def test_fleet_signals_equal_the_reference():
    snap = {"replicas": {
        "w0": {"ready": True, "live": True,
               "stats": {"queue_depth": 3.0, "inflight": 1.0,
                         "completed": 40.0, "failed": 2.0, "shed": 1.0}},
        "w1": {"ready": False, "live": True, "stats": {}}},
        "memory": {"total_bytes": 1234.0}}
    status = [{"objective": "availability", "burning": True,
               "breaching": False, "burn_fast": 17.5},
              {"objective": "latency", "burning": False,
               "breaching": False, "burn_fast": 0.5}]
    router = {"replicas": {"w0": {"weight": 0.5}}}
    for kw in ({}, {"admission": CAP, "mesh_shape": "2x2"}):
        assert tap.fleet_signals(snap, status, router, 99.0, **kw) == \
            jap.fleet_signals(snap, status, router, 99.0, **kw)


# -- SLO engine and goodput ------------------------------------------------------

def _slo_samples(seed, n):
    rng = np.random.default_rng(seed)
    admitted = bad = 0.0
    lat = {"5.0": 0.0, "50.0": 0.0, "500.0": 0.0, "+Inf": 0.0}
    out = []
    for i in range(n):
        k = float(rng.integers(0, 200))
        admitted += k
        bad += float(rng.binomial(int(k), 0.02 if i % 40 < 30 else 0.4))
        for le, p in (("5.0", 0.5), ("50.0", 0.9), ("500.0", 0.99),
                      ("+Inf", 1.0)):
            lat[le] += round(k * p)
        s = {"t": 100.0 + 15.0 * i, "admitted": admitted, "bad": bad,
             "latency_buckets": dict(lat)}
        if i % 7 == 3:
            s["ttft_buckets"] = dict(lat)
        if i == n // 2:                       # a replica restart
            admitted, bad = admitted / 4, bad / 4
            s.update(admitted=admitted, bad=bad)
        out.append(s)
    return out


def _run_slo(mod, events_mod, config_mod, path, samples):
    objectives = [mod.Objective("availability", "availability", 0.99),
                  mod.Objective("latency", "latency", 0.95, budget_ms=50.0),
                  mod.Objective("ttft", "ttft", 0.9, budget_ms=5.0)]
    config_mod.set("observability.events_path", str(path))
    try:
        eng = mod.SloEngine(objectives, clock=lambda: 0.0,
                            fast_window_s=300.0, slow_window_s=3600.0,
                            fast_burn=14.4, slow_burn=6.0)
        statuses = [eng.observe(s) for s in samples]
    finally:
        config_mod.unset("observability.events_path")
        events_mod.close()
    evs = [json.loads(line) for line in open(path, encoding="utf-8")]
    for e in evs:
        e.pop("ts")
    return statuses, [e for e in evs if e["type"] == "slo"]


def test_slo_engine_observe_equals_the_reference(tmp_path):
    samples = _slo_samples(5, 300)
    got = _run_slo(tslo, tevents, tconfig, tmp_path / "t.jsonl", samples)
    want = _run_slo(jslo, jevents, jconfig, tmp_path / "j.jsonl", samples)
    assert got == want
    assert any(s["burning"] for ss in got[0] for s in ss)
    assert {e["name"] for e in got[1]} >= {"burn", "breach", "recover"}
    assert tslo.fraction_le({"1": 2, "10": 8, "+Inf": 10}, 5.0) == \
        jslo.fraction_le({"1": 2, "10": 8, "+Inf": 10}, 5.0)


def _run_goodput(mod, events_mod, config_mod, path):
    rng = random.Random(3)
    meter = mod.GoodputMeter(deadline_s=0.25, bucket_s=5.0)
    config_mod.set("observability.events_path", str(path))
    try:
        for i in range(400):
            t = i * 0.05
            tid = f"q{i:04d}"
            meter.offer(tid, t)
            r = rng.random()
            if r < 0.08:
                meter.shed(tid)
            elif r < 0.12:
                meter.expire(tid)
            else:
                meter.complete(tid, t + rng.expovariate(8.0))
        out = meter.export(lane="serve")
    finally:
        config_mod.unset("observability.events_path")
        events_mod.close()
    evs = [json.loads(line) for line in open(path, encoding="utf-8")]
    for e in evs:
        e.pop("ts")
    return out, evs


def test_goodput_export_equals_the_reference(tmp_path):
    got = _run_goodput(tgoodput, tevents, tconfig, tmp_path / "t.jsonl")
    want = _run_goodput(jgoodput, jevents, jconfig, tmp_path / "j.jsonl")
    assert _canon(got) == _canon(want)
    assert got[1] and got[1][0]["type"] == "workload"


# -- loadgen ---------------------------------------------------------------------

TRACES = {
    "constant": dict(duration_s=30.0, rate=6.0),
    "diurnal": dict(duration_s=60.0, rate=5.0, shape="diurnal",
                    diurnal_amplitude=0.8),
    "spike": dict(duration_s=40.0, rate=4.0, shape="spike",
                  spike_start_s=10.0, spike_len_s=5.0, spike_factor=6.0),
    "pareto": dict(duration_s=30.0, rate=6.0, process="pareto",
                   pareto_alpha=1.3),
    "sessions": dict(duration_s=30.0, rate=3.0, session_turns=4,
                     think_s=1.5),
    "tenants": dict(duration_s=30.0, rate=8.0,
                    tenants=(("gold", 3.0), ("free", 1.0))),
}


@pytest.mark.parametrize("shape", sorted(TRACES))
def test_loadgen_schedule_equals_the_reference(shape):
    kw = TRACES[shape]
    for seed in (0, 7):
        got = tloadgen.generate(tloadgen.Trace(**kw), seed)
        want = jloadgen.generate(jloadgen.Trace(**kw), seed)
        assert tloadgen.schedule_fingerprint(got) == \
            jloadgen.schedule_fingerprint(want)
        assert [dataclasses.astuple(a) for a in got] == \
            [dataclasses.astuple(a) for a in want]
        assert tloadgen.bucket_counts(got, 2.0) == \
            jloadgen.bucket_counts(want, 2.0)
        assert tloadgen.Trace(**kw).describe() == \
            jloadgen.Trace(**kw).describe()
    assert got, f"{shape}: empty schedule"


def test_loadgen_simulators_and_payloads_equal_the_reference():
    kw = TRACES["spike"]
    sched_t = tloadgen.generate(tloadgen.Trace(**kw), 4)
    sched_j = jloadgen.generate(jloadgen.Trace(**kw), 4)
    stalls = [(12.0, 14.5)]
    assert tloadgen.simulate_open_loop(sched_t, 0.09, stalls=stalls) == \
        jloadgen.simulate_open_loop(sched_j, 0.09, stalls=stalls)
    for clients in (1, 4):
        assert tloadgen.simulate_closed_loop(
            sched_t, 0.09, stalls=stalls, clients=clients) == \
            jloadgen.simulate_closed_loop(
                sched_j, 0.09, stalls=stalls, clients=clients)
    for a, b in zip(tloadgen.feature_rows(5, 3, 4, seed=2),
                    jloadgen.feature_rows(5, 3, 4, seed=2)):
        np.testing.assert_array_equal(a, b)
    assert tloadgen.token_prompts(6, random.Random(1)) == \
        jloadgen.token_prompts(6, random.Random(1))
    np.testing.assert_array_equal(tloadgen.zipf_ids(64, rows=50, seed=3),
                                  jloadgen.zipf_ids(64, rows=50, seed=3))
    for a, b in zip(
            tloadgen.recommender_rows(8, dense=3, tables=((20, 2), (9, 1)),
                                      seed=5),
            jloadgen.recommender_rows(8, dense=3, tables=((20, 2), (9, 1)),
                                      seed=5)):
        np.testing.assert_array_equal(a, b)
    pt = tloadgen.PromptPopulation(random.Random(9), prefixes=4)
    pj = jloadgen.PromptPopulation(random.Random(9), prefixes=4)
    assert [pt.sample(tail_tokens=3) for _ in range(12)] == \
        [pj.sample(tail_tokens=3) for _ in range(12)]


# -- replay ----------------------------------------------------------------------

def _tick(now, queue, *, live=2, shed=0.0, burn=0.0, burning=False):
    reps = {f"w{i}": {"ready": True, "live": True, "weight": 1.0,
                      "queue_depth": float(queue), "inflight": 0.0,
                      "completed": 10.0 * now, "failed": 0.0,
                      "shed": float(shed)} for i in range(live)}
    return {"now": float(now), "replicas": reps,
            "slo": {"burning": burning, "breaching": False,
                    "burn_fast": float(burn)},
            "memory": {"total_bytes": 0.0}}


def _spike_ticks():
    ticks = [_tick(0.0, 0.0)]
    for k in range(1, 6):
        ticks.append(_tick(10.0 * k, 3.0 if k <= 3 else 5.0,
                           shed=4.0 * k))
    for k in range(6, 12):
        ticks.append(_tick(10.0 * k, 0.0, live=3, shed=20.0))
    return ticks


RECORDED = dict(min_replicas=2, max_replicas=8, scale_up_queue=4.0,
                scale_down_queue=0.0)


def _write_log(path, policy, ticks, decisions):
    """A sidecar in the shape the live autopilot records."""
    ts = 0.0
    with open(path, "w", encoding="utf-8") as fh:
        row = {"ts": ts, "type": "autopilot_signals", "name": "policy"}
        row.update(dataclasses.asdict(policy))
        fh.write(json.dumps(row) + "\n")
        for s in ticks:
            ts += 1.0
            fh.write(json.dumps({"ts": ts, "type": "autopilot_signals",
                                 "name": "tick", "signals": s}) + "\n")
            for d in decisions:
                if d["t"] != s["now"]:
                    continue
                row = {"ts": ts, "type": "autopilot", "name": d["action"]}
                row.update({k: v for k, v in d.items() if k != "action"})
                if not d["suppressed"]:
                    row["replica"] = "w2"
                fh.write(json.dumps(row) + "\n")


def test_replay_and_ranking_equal_the_reference():
    ticks = _spike_ticks()
    got = trp.replay_decisions(ticks, tap.AutopilotPolicy(**RECORDED))
    want = jrp.replay_decisions(ticks, jap.AutopilotPolicy(**RECORDED))
    assert _canon(got) == _canon(want) and got
    cands = {"recorded": {}, "aggressive": {"scale_up_queue": 2.0},
             "lazy": {"scale_up_queue": 100.0}}
    rt = trp.rank_policies(ticks, {k: tap.AutopilotPolicy(**{**RECORDED, **v})
                                   for k, v in cands.items()})
    rj = jrp.rank_policies(ticks, {k: jap.AutopilotPolicy(**{**RECORDED, **v})
                                   for k, v in cands.items()})
    assert _canon(rt) == _canon(rj)
    assert [s["policy"] for s in rt] == ["aggressive", "recorded", "lazy"]
    fid = trp.fidelity_check(got, got)
    assert trp.format_ranking(rt, fid) == jrp.format_ranking(rj, fid)
    assert trp.parse_overrides("a=2,b=x,c=true") == \
        jrp.parse_overrides("a=2,b=x,c=true")


def _cli_json(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1])


@pytest.mark.parametrize("argv", [
    ["loadgen", "--rate", "5", "--duration", "20", "--seed", "3", "--json"],
    ["loadgen", "--rate", "3", "--duration", "30", "--shape", "spike",
     "--spike-start", "5", "--spike-len", "4", "--spike-factor", "5",
     "--process", "pareto", "--session-turns", "3", "--think", "0.5",
     "--bucket", "2.5", "--seed", "11", "--json"],
])
def test_cli_loadgen_json_equals_the_reference(argv, capsys):
    assert _cli_json(tcli.main, argv, capsys) == \
        _cli_json(jcli.main, argv, capsys)


def test_cli_autopilot_replay_json_equals_the_reference(tmp_path, capsys):
    ticks = _spike_ticks()
    pol = jap.AutopilotPolicy(**RECORDED)
    path = tmp_path / "events.jsonl"
    _write_log(path, pol, ticks, jrp.replay_decisions(ticks, pol))
    argv = ["autopilot", "replay", str(path), "--json",
            "--candidate", "eager:scale_up_queue=2,scale_cooldown_s=10",
            "--candidate", "lazy:scale_up_queue=50"]
    rc_t, got = _cli_json(tcli.main, argv, capsys)
    rc_j, want = _cli_json(jcli.main, argv, capsys)
    assert (rc_t, got) == (rc_j, want)
    assert rc_t == 0 and got["fidelity"]["identical"] is True
    # the human-readable table too
    argv_text = argv[:3]
    assert tcli.main(argv_text) == 0
    text_t = capsys.readouterr().out
    assert jcli.main(argv_text) == 0
    assert text_t == capsys.readouterr().out


# -- the port's Autopilot over an in-process CPU Fleet ---------------------------

_DIM = 4


@pytest.fixture
def cpu():
    tconfig.set("runtime.device", "cpu")
    tmetrics.get_registry().reset()
    yield
    tconfig.unset("runtime.device")
    tmetrics.get_registry().reset()


def _model():
    m = TorchModel(inputCol="x", outputCol="y", miniBatchSize=8)
    return m.set_model("mlp_tabular", input_dim=_DIM, hidden=[8],
                       num_classes=3, seed=7)


def _acted(ds):
    return [d for d in ds if not d["suppressed"]]


def test_autopilot_scales_fleet_out_and_back_and_replays_on_the_reference(
        cpu, tmp_path):
    model = _model()
    xs = [np.arange(_DIM, dtype=np.float32) + i for i in range(12)]
    # the same batches as the fleet's (4 rows each): torch on the CPU may
    # give other bits for a row in a batch of another shape
    ref = Server({"m": model}, max_batch=4, queue_depth=32, start=False)
    try:
        futs = [ref.submit_async("m", x) for x in xs]
        ref.pump()
        want = [np.asarray(f.result(timeout=5)) for f in futs]
    finally:
        ref.close()
    path = str(tmp_path / "events.jsonl")
    tconfig.set("observability.events_path", path)
    try:
        vclock = {"t": 1000.0}
        fleet = Fleet({"m": model}, replicas=1, start=False,
                      server_kwargs={"max_batch": 4, "queue_depth": 32})
        policy = tap.AutopilotPolicy(
            min_replicas=1, max_replicas=2, scale_up_queue=2.0,
            scale_down_queue=0.0, scale_cooldown_s=10.0, window_s=120.0,
            max_actions_per_window=8)
        pilot = tap.Autopilot(fleet, policy=policy,
                              clock=lambda: vclock["t"])
        try:
            futs = [fleet.replicas[0].server.submit_async("m", x)
                    for x in xs]
            ds = pilot.tick()                 # sees the backlog
            assert [d["action"] for d in _acted(ds)] == ["scale_up"]
            assert _acted(ds)[0]["replica"] == "r1"
            assert len(fleet.replicas) == 2
            for r in fleet.replicas:
                r.server.pump()
            got = [np.asarray(f.result(timeout=5)) for f in futs]
            assert all(np.array_equal(a, b) for a, b in zip(got, want))
            vclock["t"] += 30.0
            ds2 = pilot.tick()                # idle: unwind
            assert [d["target"] for d in _acted(ds2)
                    if d["action"] == "scale_down"] == ["r1"]
            assert len(fleet.replicas) == 1
            assert pilot.stats()["by_action"] == {"scale_down": 1,
                                                  "scale_up": 1}
        finally:
            fleet.close()
    finally:
        tevents.close()
        tconfig.unset("observability.events_path")
    lines = [json.loads(line) for line in open(path, encoding="utf-8")]
    assert {"scale_up", "scale_down"} <= {
        e["name"] for e in lines if e["type"] == "autopilot"}
    # the port's recording replays byte-identically under the REFERENCE
    for rp in (jrp, trp):
        log = rp.load_log([path])
        assert len(log["ticks"]) == 2
        fid = rp.fidelity_check(log["decisions"], rp.replay_decisions(
            log["ticks"], rp.policy_from_fields(log["policy"])))
        assert fid["identical"] is True and fid["recorded"] >= 2


def test_autopilot_records_the_reshard_actuation_error(cpu, tmp_path):
    path = str(tmp_path / "events.jsonl")
    tconfig.set("observability.events_path", path)
    try:
        with Fleet({"m": _model()}, replicas=1,
                   server_kwargs={"max_batch": 4}) as fleet:
            fleet.submit("m", np.zeros((1, _DIM), np.float32))
            policy = tap.AutopilotPolicy(
                min_replicas=1, max_replicas=1, hbm_limit_bytes=1,
                reshard_wide="4x2", reshard_hbm_frac=0.5,
                reshard_cooldown_s=60.0, scale_down_queue=-1.0)
            vclock = {"t": 1000.0}
            pilot = tap.Autopilot(fleet, policy=policy,
                                  clock=lambda: vclock["t"])
            ds = pilot.tick()
            (d,) = [d for d in ds if d["lever"] == "reshard"]
            assert d["action"] == "reshard_wide" and not d["suppressed"]
            # a 4x2 placement needs eight ranks led from this process
            assert d["error"].startswith("RuntimeError")
            assert "process group" in d["error"]
            assert pilot.stats()["errors"] == 1
            vclock["t"] += 10.0               # inside the cooldown
            (d2,) = [d for d in pilot.tick() if d["lever"] == "reshard"]
            assert d2["suppressed"]
            assert d2["reason"].startswith("cooldown:reshard")
            assert fleet.submit("m", np.zeros((1, _DIM), np.float32)) \
                is not None                   # the fleet keeps serving
    finally:
        tevents.close()
        tconfig.unset("observability.events_path")
    errs = [json.loads(line) for line in open(path, encoding="utf-8")]
    errs = [e for e in errs if e["type"] == "autopilot"
            and e["name"] == "reshard_wide" and "error" in e]
    assert len(errs) == 1
    log = jrp.load_log([path])
    fid = jrp.fidelity_check(log["decisions"], jrp.replay_decisions(
        log["ticks"], jrp.policy_from_fields(log["policy"])))
    assert fid["identical"] is True
