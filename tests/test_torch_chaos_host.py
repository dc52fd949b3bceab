"""The port's process and control-plane chaos scenarios: ``host`` (a real
``cli serve`` worker SIGKILLed), ``elastic`` (a worker SIGKILLed mid
autopilot-driven scale-up), ``fleetprefix`` and ``autopilot``.

The reference's own ``host`` and ``autopilot`` tests fail in the reference
(ROADMAP §C), so these are held to their own verdicts: green, and the same
schedule and invariants twice for one seed. The invariants a CUDA graph
cannot keep are restated, and each verdict names them under ``restated``.
"""
import pytest

from mmlspark_tpu_torch.reliability import chaos
from mmlspark_tpu_torch.utils import config as tconfig

SIZES = {"host": {"replicas": 2, "requests": 12},
         "elastic": {"replicas": 2, "requests": 12},
         "fleetprefix": {"replicas": 3, "requests": 12},
         "autopilot": {"replicas": 3}}
RESTATED = ["fresh_worker_captures_exactly_buckets",
            "kernel_build_dir_unchanged", "no_nvcc_runs"]
# the reference's invariant keys, less the restated ones, plus RESTATED
KEYS = {
    "host": {"zero_failed_requests", "restart_observed",
             "supervisor_events", "merged_report_coherent",
             "crash_loop_breaker_open", "no_restart_flapping",
             "no_unhandled_exceptions", *RESTATED},
    "elastic": {"zero_failed_requests", "scale_up_actuated", "kill_landed",
                "desired_equals_live", "killed_slot_respawned",
                "no_zombie_in_rotation", "scale_down_retired",
                "replay_fidelity", "no_unhandled_exceptions", *RESTATED},
    "fleetprefix": {"all_sequences_complete", "tokens_bit_identical",
                    "victim_routed_to_leader", "failover_observed",
                    "sessions_absorbed", "hit_rate_recovers",
                    "steady_compiles_zero", "no_unhandled_exceptions"},
    "autopilot": {"autopilot_sheds_fewer", "scaled_up_under_spike",
                  "replicas_recovered", "weights_recovered",
                  "admission_restored", "no_flap",
                  "suppressed_decisions_visible", "scores_bit_identical",
                  "steady_compiles_zero", "zero_hard_failures",
                  "all_requests_resolved"},
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tconfig.set("runtime.device", "cpu")
    root = tmp_path_factory.mktemp("chaos")
    try:
        return {name: [chaos.run_named(name, 0, str(root / f"{name}-{i}"),
                                       **kw) for i in range(2)]
                for name, kw in SIZES.items()}
    finally:
        tconfig.unset("runtime.device")


@pytest.mark.parametrize("name", sorted(SIZES))
def test_scenario_is_green(name, runs):
    v = runs[name][0]
    assert set(v["invariants"]) == KEYS[name]
    assert v["passed"] and all(v["invariants"].values()), \
        (v["invariants"], v["errors"])


@pytest.mark.parametrize("name", sorted(SIZES))
def test_scenario_is_deterministic_per_seed(name, runs):
    a, b = runs[name]
    assert a["invariants"] == b["invariants"]
    if name == "autopilot":
        assert a["schedule"] == b["schedule"]
        assert a["static"]["shed"] == b["static"]["shed"]
        assert a["autopilot"]["by_action"] == b["autopilot"]["by_action"]
    elif name == "host":
        keep = ("kill_at", "kill_replica")
        assert {k: a["schedule"][k] for k in keep} == \
            {k: b["schedule"][k] for k in keep}
        assert a["crash_loop"] == b["crash_loop"]
    elif name == "elastic":
        keep = ("kill_replica", "kill_mode")
        assert {k: a["schedule"][k] for k in keep} == \
            {k: b["schedule"][k] for k in keep}
    else:
        assert a["schedule"] == b["schedule"]


@pytest.mark.parametrize("name", ["host", "elastic"])
def test_fresh_worker_invariants_are_restated_and_named(name, runs):
    v = runs[name][0]
    named = (["warm_restart"] if name == "host"
             else ["steady_compiles_zero", "warm_scale_up"])
    assert sorted(v["restated"]) == named
    assert all(v["restated"][k] == RESTATED for k in named)
    facts = v["host"]["restarted_worker"] if name == "host" \
        else v["elastic"]["new_worker"]
    assert facts == {"captures": 3.0, "nvcc_runs": 0.0}
