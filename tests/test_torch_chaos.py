"""The port's chaos harness (``reliability/chaos.py``) against the JAX
package's: the seeded fault plans are equal for seeds 0-7, and the
``train``, ``fleet`` and ``decode`` scenarios give the reference's
``invariants`` keys, all true, and the same verdict twice for one seed
(its schedule, faults and invariants). The process and control-plane
scenarios are in ``test_torch_chaos_host.py``."""
import json
from dataclasses import asdict

import pytest

from mmlspark_tpu.reliability import chaos as jchaos
from mmlspark_tpu_torch.reliability import chaos
from mmlspark_tpu_torch.utils import config as tconfig

# small runs, the reference tests' sizes
SIZES = {"train": {"requests": 12}, "fleet": {"replicas": 3, "requests": 12},
         "decode": {"replicas": 2, "requests": 5}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two port runs of each scenario with seed 0 (the second of train
    through ``cli chaos``), and the JAX package's run."""
    tconfig.set("runtime.device", "cpu")
    root = tmp_path_factory.mktemp("chaos")
    out = {}
    try:
        for name, kw in SIZES.items():
            a = chaos.run_named(name, 0, str(root / f"{name}-a"), **kw)
            if name == "train":
                from mmlspark_tpu_torch.cli import main
                rc = main(["chaos", "--scenario", "train", "--seed", "0",
                           "--requests", "12", "--out",
                           str(root / "train-b")])
                with open(root / "train-b" / chaos.VERDICT_FILE) as f:
                    b = json.load(f)
                b["rc"] = rc
            else:
                b = chaos.run_named(name, 0, str(root / f"{name}-b"), **kw)
            out[name] = (a, b)
        out["jax"] = {
            "train": jchaos.run_scenario(0, str(root / "j-train")),
            "fleet": jchaos.run_fleet_scenario(0, str(root / "j-fleet"),
                                               **SIZES["fleet"]),
            "decode": jchaos.run_decode_scenario(0, str(root / "j-decode"),
                                                 **SIZES["decode"]),
        }
    finally:
        tconfig.unset("runtime.device")
    return out


def _specs(plan):
    return [{k: v for k, v in asdict(s).items() if k != "exc"}
            for s in plan.specs]


@pytest.mark.parametrize("seed", range(8))
def test_plans_equal_the_jax_package(seed):
    for steps in (6, 8, 12):
        assert _specs(chaos.generate_train_plan(seed, steps)) == \
            _specs(jchaos.generate_train_plan(seed, steps))
    for requests in (5, 12, 24):
        assert _specs(chaos.generate_serve_plan(seed, requests)) == \
            _specs(jchaos.generate_serve_plan(seed, requests))


@pytest.mark.parametrize("name", sorted(SIZES))
def test_scenario_keys_equal_the_reference_and_are_green(name, runs):
    a, _ = runs[name]
    want = runs["jax"][name]
    assert want["passed"], want["errors"]
    assert sorted(a["invariants"]) == sorted(want["invariants"])
    assert a["passed"] and all(a["invariants"].values()), \
        (a["invariants"], a["errors"])


@pytest.mark.parametrize("name", sorted(SIZES))
def test_scenario_is_deterministic_per_seed(name, runs):
    a, b = runs[name]
    a = json.loads(json.dumps(a))      # the file's form, as b was read
    assert b["passed"] and a["invariants"] == b["invariants"]
    if name == "train":
        assert b["rc"] == 0
        assert a["train"]["faults"] == b["train"]["faults"]
        assert a["serve"]["faults"] == b["serve"]["faults"]
        assert a["train"]["restarts"] >= 1
        assert a["metrics_flush_steps"] % a["save_every"] != 0
    else:
        assert a["schedule"] == b["schedule"]


def test_unknown_scenario_lists_the_registry_and_exits_2(capsys):
    """``tests/test_supervisor.py``'s registry tests on the port: an
    unknown name lists all eleven scenarios and exits 2."""
    from mmlspark_tpu_torch.cli import main
    assert main(["chaos", "--scenario", "bogus"]) == 2
    err = capsys.readouterr().err
    assert "unknown scenario 'bogus'" in err
    names = {"train", "fleet", "decode", "host", "fleet_sharded",
             "decode_sharded", "autopilot", "elastic", "recommender",
             "fleetprefix", "reshard"}
    for name in names:
        assert f"  {name} " in err
    assert set(chaos.SCENARIOS) == names == set(jchaos.SCENARIOS)
    assert all(desc for desc in chaos.SCENARIOS.values())
    with pytest.raises(KeyError, match="unknown chaos scenario"):
        chaos.run_named("bogus", 0, "unused")
