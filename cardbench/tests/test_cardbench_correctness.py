"""``correct`` comes out false when the timed path is broken underneath:
each cell driven on the CPU at a size a test run can hold, the harness's
look for a card skipped, once sound and once with each fault the cell can
have; and once with the control (the reference in float8 operands) in the
program's place, judged by the cell's own comparison."""
import time

import numpy as np
import pytest
import torch

from cardbench.harness import Cell, run_cell


def small(name):
    cell = Cell(name)
    if name == "vit_b16.train":
        # the cell's batch: the loss of fewer rows rounds too coarsely in
        # bf16 on the CPU for the cell's limit
        cell.cfg = dict(cell.cfg, image_size=32,
                        arch_args=dict(cell.cfg["arch_args"], image_size=32))
        cell.traffic = dict(cell.traffic, epoch_images=512, warm_steps=1)
    elif name == "resnet50.featurize":
        cell.traffic = dict(cell.traffic, image=[64, 64, 3], pool_images=16,
                            frame_images=8, mini_batch=4, warm_frames=1)
    else:
        cell.traffic = dict(cell.traffic, image=[64, 64, 3], pool_images=16,
                            buckets=[1, 4], phases=[[1.0, 8.0]],
                            warm_seconds=0.5)
    return cell


def run(name, seconds=1.5, stand_in=None):
    return run_cell(name, 2**31 + 17, seconds, False, time.perf_counter(),
                    device="cpu", cell=small(name), stand_in=stand_in)


@pytest.fixture(autouse=True)
def _cpu_device():
    from mmlspark_tpu_torch.utils import config
    yield
    config.set("runtime.device", "cuda")


@pytest.mark.parametrize("name", ["resnet50.featurize", "resnet50.serve",
                                  "vit_b16.train"])
def test_a_sound_run_is_correct(name):
    r = run(name)
    assert r["correct"], r["compared"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "compared"


def _alter_first_row(out):
    out = np.array(out, copy=True)
    out[0] = out[0] * 1.5 + 1.0
    return out


def test_featurize_an_answer_altered_where_it_is_produced(monkeypatch):
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    emit = TorchModel._emit
    monkeypatch.setattr(TorchModel, "_emit", lambda self, frame, outs: emit(
        self, frame, [_alter_first_row(outs[0])] + list(outs[1:])))
    r = run("resnet50.featurize")
    assert not r["correct"]


def test_serve_an_answer_altered_where_it_is_produced(monkeypatch):
    from mmlspark_tpu_torch.serve.registry import ModelEntry
    score = ModelEntry.score
    monkeypatch.setattr(ModelEntry, "score",
                        lambda self, x: _alter_first_row(score(self, x)))
    assert not run("resnet50.serve")["correct"]


def test_train_a_step_that_leaves_the_state_unchanged(monkeypatch):
    from mmlspark_tpu_torch.parallel.optim import OptimizerState
    monkeypatch.setattr(OptimizerState, "step", lambda self: None)
    r = run("vit_b16.train")
    assert not r["correct"]
    assert r["compared"]["change_norm_gap"]["value"] == pytest.approx(1.0)


def test_train_half_the_batch_left_out(monkeypatch):
    from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer
    step = DistributedTrainer._local_forward_backward

    def half(self, module, batch, gen):
        n = next(iter(batch.values())).shape[0] // 2
        return step(self, module, {k: v[:n] for k, v in batch.items()}, gen)
    monkeypatch.setattr(DistributedTrainer, "_local_forward_backward", half)
    assert not run("vit_b16.train")["correct"]


@pytest.mark.parametrize("name", ["resnet50.featurize", "resnet50.serve",
                                  "vit_b16.train"])
def test_the_control_reads_over_the_limits(name):
    cell = small(name)
    r = run(name, stand_in="fp8")
    assert not r["correct"], r["compared"]
    assert any(c["value"] > cell.limits[k]
               for k, c in r["compared"].items()), r["compared"]


def _ranks(*args):
    import json
    import os
    import subprocess
    import sys
    from cardbench.harness import ROOT
    env = dict(os.environ, MMLSPARK_TPU_TORCH_RUNTIME_DIST_BACKEND="gloo",
               OMP_NUM_THREADS="2")
    done = subprocess.run(
        [sys.executable, "-m", "mmlspark_tpu_torch.cli", "run",
         "cardbench/tests/dp_ranks.py", "--nprocs", "4", "--platform", "cpu",
         "--", *args], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=900)
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("fault", ["", "exchange"])
def test_data_parallel_on_four_ranks_and_the_exchange_left_out(fault):
    r = _ranks("--fault", fault) if fault else _ranks()
    assert r["device"]["count"] == 4
    assert r["correct"] is (fault == ""), r["compared"]
