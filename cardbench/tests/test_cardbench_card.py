"""On a card: every cell's command with a short window gives a result line
that meets the contract and reads ``correct``. Run on the card with
``python -m pytest -m cuda cardbench/tests``."""
import json
import subprocess
import sys

import pytest

from cardbench.harness import ROOT, benchmark


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in benchmark()["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(cell, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    chips = [w["chips"] for w in benchmark()["workloads"] if w["name"] == cell][0]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} cards")
    done = subprocess.run(
        [sys.executable, "cardbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 99), "--seconds", "4", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert done.returncode == 0, done.stderr[-3000:]
    r = json.loads(done.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert list(r)[-1] == "compared"
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert len(r["breakdown"]["device_ops"]) <= 10
        for name, m in r["metrics"].items():
            if "roofline" in name or "mfu" in name:
                assert 0 < m["value"] <= 105, name


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in benchmark()["workloads"]])
def test_the_control_in_the_programs_place_is_not_correct(cell):
    """The float8 reference stands in for the program at the cell's own
    shapes and load (``control.py``), and the cell's comparison rejects it."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    chips = [w["chips"] for w in benchmark()["workloads"] if w["name"] == cell][0]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} cards")
    done = subprocess.run(
        [sys.executable, "cardbench/control.py", "--workload", cell,
         "--control-seeds", str(2**31 + 101), "--seconds", "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert done.returncode == 0, done.stderr[-3000:]
    lines = [json.loads(x) for x in done.stdout.splitlines()
             if x.startswith("{")]
    runs = [x for x in lines if "control_seed" in x]
    assert runs and not any(x["correct"] for x in runs), runs


def test_without_a_card_the_run_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    done = subprocess.run(
        [sys.executable, "cardbench/run.py", "--workload",
         benchmark()["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert done.returncode != 0 and done.stdout.strip() == ""
    assert "CUDA" in done.stderr


def test_without_the_port_beside_it_the_run_prints_no_result(tmp_path):
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "cardbench", tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    done = subprocess.run(
        [sys.executable, "cardbench/run.py", "--workload",
         benchmark()["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert done.returncode != 0 and done.stdout.strip() == ""
    assert "mmlspark_tpu_torch" in done.stderr
