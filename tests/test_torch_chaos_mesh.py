"""The port's four mesh-bound chaos scenarios against the JAX package's.

``fleet_sharded``, ``decode_sharded``, ``recommender`` and ``reshard``
(``reliability/chaos.py``) run on one module-scoped pool of 4 gloo ranks
(``mmlspark_tpu_torch.testing.ranks.RankPool``), rank 0 leading and the
others following (``tests/torch_chaos_ranks.py``, which imports no JAX):
``SHARDED_MESH`` is then data 2 x tensor 2, the reference's 4x2 at half
the data axis, and ``reshard`` moves onto its tensor-2 sub-mesh
(``chaos.RESHARD_MESH``). Each scenario runs twice on the port with seed
0, at the reference tests' sizes, and once on the JAX package (8 virtual
CPU devices) in this process. Held, exactly:

- the verdict's invariant keys equal the JAX verdict's, all true;
- the seed-derived schedule fields equal the JAX package's, and the whole
  schedule is equal across the two port runs;
- no placement is left on any rank, and the leader's ledger is empty
  after close where the verdict reads it;
- a mesh-bound scenario outside a process group raises, naming
  ``--nprocs``; ``cli chaos --scenario recommender --nprocs 2 --platform
  cpu`` runs end to end (rc 0, the printed verdict passed).

The file takes about a minute on the CPU (the pool's start and the
decode scenario's meshed steps are most of it).
"""
import json
import os
import subprocess
import sys

import pytest

from mmlspark_tpu.reliability import chaos as jchaos
from mmlspark_tpu_torch.reliability import chaos
from mmlspark_tpu_torch.testing.ranks import RankPool

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
# the reference tests' sizes
SIZES = {"fleet_sharded": {"replicas": 3, "requests": 12},
         "decode_sharded": {"replicas": 2, "requests": 5},
         "recommender": {"requests": 12},
         "reshard": {"requests": 12}}
# the schedule fields that derive from the seed alone
SEEDED = {"fleet_sharded": ("kill_at", "kill_replica"),
          "decode_sharded": ("kill_request", "max_new"),
          "recommender": ("kill_at", "kill_replica"),
          "reshard": ("reshard_at", "victim")}


def _jax(name, outdir):
    kw = SIZES[name]
    if name == "fleet_sharded":
        return jchaos.run_fleet_scenario(0, outdir, mesh=jchaos.SHARDED_MESH,
                                         **kw)
    if name == "decode_sharded":
        return jchaos.run_decode_scenario(0, outdir,
                                          mesh=jchaos.SHARDED_MESH, **kw)
    if name == "recommender":
        return jchaos.run_recommender_scenario(0, outdir, **kw)
    return jchaos.run_reshard_scenario(0, outdir, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two port runs of each scenario with seed 0 on 4 ranks (rank 0's
    verdict and the followers' command counts), the JAX run, and the
    pool for the file's other led calls."""
    root = tmp_path_factory.mktemp("chaos_mesh")
    out = {}
    with RankPool(4, paths=[TESTS, REPO], timeout_s=300.0) as pool:
        for name, kw in SIZES.items():
            out[name] = []
            for i in range(2):
                res = pool.run("torch_chaos_ranks:scenario", name, 0,
                               str(root / f"{name}-{i}"), kw)
                out[name].append((res[0], res[1:]))
        for name in SIZES:
            out[name].append(_jax(name, str(root / f"{name}-jax")))
        out["pool"] = pool
        yield out


def test_registry_equals_the_reference():
    assert sorted(chaos.SCENARIOS) == sorted(jchaos.SCENARIOS)
    assert len(chaos.SCENARIOS) == 11
    assert set(chaos.MESH_SCENARIOS) == {"fleet_sharded", "decode_sharded",
                                         "recommender", "reshard"}
    assert chaos.SHARDED_MESH == jchaos.SHARDED_MESH


@pytest.mark.parametrize("name", sorted(SIZES))
def test_keys_equal_the_reference_and_are_green(name, runs):
    (a, fa), (b, fb), want = runs[name]
    assert want["passed"], want["errors"]
    for v in (a, b):
        assert sorted(v["invariants"]) == sorted(want["invariants"])
        assert v["passed"] and all(v["invariants"].values()), \
            (v["invariants"], v["errors"])
        assert v["scenario"] == want["scenario"] == name
    # the followers ran the leader's commands: the scenario was meshed
    for f in fa + fb:
        assert f["follower_commands"] > 0


@pytest.mark.parametrize("name", sorted(SIZES))
def test_schedule_equals_the_reference_and_repeats(name, runs):
    (a, _), (b, _), want = runs[name]
    for key in SEEDED[name]:
        assert a["schedule"][key] == want["schedule"][key], key
    assert a["schedule"] == b["schedule"]
    assert a["invariants"] == b["invariants"]


def test_seeded_schedules_are_the_reference_tests(runs):
    """The JAX package's seed-0 schedules, as its own tests read them."""
    assert runs["fleet_sharded"][0][0]["schedule"]["kill_at"] == 8
    assert runs["fleet_sharded"][0][0]["schedule"]["kill_replica"] == "r2"
    decode = runs["decode_sharded"][0][0]["schedule"]
    assert decode["kill_request"] == 1
    assert decode["max_new"] == [4, 24, 4, 5, 4]
    statuses = runs["reshard"][0][0]["schedule"]["statuses"]
    assert [s["status"] for s in statuses] == \
        ["resharded", "skipped_dead", "resharded"]


@pytest.mark.parametrize("name", sorted(SIZES))
def test_no_placement_left_on_any_rank(name, runs):
    for v, _ in runs[name][:2]:
        ranks = v["ranks"]
        assert ranks["world"] == 4
        assert ranks["placements_left"] == [[], [], [], []]
        assert v["left_after"] == [[], [], [], []]
        # every rank's kernel launches were read (none on the CPU)
        assert len(ranks["launches"]) == 4
        if "ledger" in v:
            assert v["ledger"]["total_bytes_after_close"] == 0


def test_recommender_ledger_equals_the_reference(runs):
    """The tables charged per shard: the same bytes as the reference's
    ledger line (padded rows x dim x 4 B, halved by tensor 2)."""
    (a, _), _, want = runs["recommender"]
    for key in ("table_bytes_serving", "expected_shard_bytes",
                "table_bytes_after_close", "total_bytes_after_close"):
        assert a["ledger"][key] == want["ledger"][key], key
    assert a["restated"]["ledger_reconciles_on_close"] == \
        ["leader_ledger_zero_after_close", "no_placement_on_any_rank"]


def test_reshard_lands_on_the_tensor_2_sub_mesh(runs):
    (a, _), _, want = runs["reshard"]
    assert a["mesh_to"] == chaos.RESHARD_MESH == "1x2"
    assert want["mesh_to"] == "4x2"
    assert a["schedule"]["resharded"] == want["schedule"]["resharded"] == 2
    assert "mesh_to" in a["restated"]
    assert a["ledger"]["params_bytes_serving"] > 0


def test_decode_sharded_keeps_the_prefix_ledger(runs):
    (a, _), _, want = runs["decode_sharded"]
    assert a["prefix"]["shared_blocks_at_kill"] == \
        want["prefix"]["shared_blocks_at_kill"]
    assert a["schedule"]["killed_replica"]
    assert a["decode"]["completed"] == want["decode"]["completed"] == 5


def test_a_kill_inside_a_meshed_call_leaves_the_channel_usable(runs):
    """The kill lands while the victim's executor is inside
    ``Channel.call`` (its leader part held 0.5 s): the call finishes (or
    fails retryably), the channel stays up, the victim's release drops
    only its own holds on the placement the survivor shares, and the
    survivor answers bit-equal to before."""
    res = runs["pool"].run("torch_chaos_ranks:kill_mid_call", 0)[0]
    assert res["client_done"]
    assert res["victim"] == "equal" or res["victim"][1], res["victim"]
    assert res["broken"] is None
    assert list(res["refs"].values()) == [1]
    assert all(len(keys) == 1 for keys in res["placed"])
    assert res["survivor"] == [True, True, True] and res["fleet"]
    assert res["left"] == [[], [], [], []]


@pytest.mark.parametrize("name", sorted(SIZES))
def test_outside_a_process_group_raises(name, tmp_path):
    """No joined channel: the scenario refuses, naming the launcher,
    rather than run on one device."""
    with pytest.raises(chaos.ChaosError, match="--nprocs"):
        chaos.run_named(name, 0, str(tmp_path / name), **SIZES[name])
    assert not (tmp_path / name / chaos.VERDICT_FILE).exists()


def test_cli_nprocs_runs_recommender_end_to_end(tmp_path):
    """``cli chaos --scenario recommender --nprocs 2 --platform cpu``:
    two ranks over gloo (picked by the launcher), rank 0 prints the
    verdict; exit 0 iff it passed."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("MMLSPARK_TPU_TORCH_")}
    proc = subprocess.run(
        [sys.executable, "-m", "mmlspark_tpu_torch.cli", "chaos",
         "--scenario", "recommender", "--seed", "0", "--nprocs", "2",
         "--platform", "cpu", "--requests", "12",
         "--out", str(tmp_path / "rec")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    verdict = json.loads(proc.stdout)
    assert verdict["passed"] and all(verdict["invariants"].values())
    assert verdict["ranks"]["world"] == 2
    assert verdict["ranks"]["placements_left"] == [[], []]
    with open(tmp_path / "rec" / chaos.VERDICT_FILE) as f:
        assert json.load(f)["schedule"] == verdict["schedule"]


@pytest.mark.parametrize("flag", [["--nprocs", "2"], ["--platform", "cpu"]])
def test_rank_flags_are_refused_for_a_single_process_scenario(flag):
    from mmlspark_tpu_torch.cli import main
    with pytest.raises(SystemExit, match="mesh-bound"):
        main(["chaos", "--scenario", "fleet"] + flag)
