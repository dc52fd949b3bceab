"""Multi-process training inputs on two ranks that share one card (gloo).

Runs only on a CUDA card (``cuda`` marker; skipped here) and imports no
JAX, so it runs on the card's machine with
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_mesh_inputs_card.py``. The ranks' functions are in
``tests/torch_input_ranks.py``:

- the local-rows ``DeviceEpochCache`` on the card: each rank builds it
  from its own rows, and its batches equal, bit for bit, its block of the
  one-rank cache's over the whole epoch (three shuffled epochs);
- a meshed ``run_dataset`` at data 2 on the card, K1 turning each rank's
  uint8 rows into the step's input: each rank streams its own half of a
  corpus, K1 launches once a step on each rank, and a run killed while
  drawing step 13 and run again from step 10 ends bit-equal to an
  uninterrupted run.
"""
import os

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.parallel.trainer import DeviceEpochCache
from mmlspark_tpu_torch.testing.ranks import RankPool

import torch_input_ranks as R

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
DATA2 = {"data": 2}


@pytest.fixture(scope="module")
def pool():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with RankPool(2, paths=[TESTS, REPO], env={
            "MMLSPARK_TPU_TORCH_RUNTIME_DEVICE": "cuda"}) as p:
        yield p


@pytest.mark.cuda
def test_local_rows_epoch_cache_on_the_card(pool):
    rng = np.random.default_rng(3)
    data = {"x": rng.normal(size=(96, 5)).astype(np.float32),
            "y": rng.integers(0, 9, 96).astype(np.int64)}
    ranks = pool.run("torch_input_ranks:local_epoch_cache", DATA2, data, 16,
                     True, 3)
    one = DeviceEpochCache(data, 16, shuffle=True, seed=7,
                           device=torch.device("cuda", 0))
    for r in ranks:
        rows = slice(8 * r["block"], 8 * r["block"] + 8)
        for e, epoch in enumerate(r["epochs"]):
            for got, want in zip(epoch, one.batches(e)):
                for k in data:
                    assert got[k].tobytes() == \
                        want[k][rows].cpu().numpy().tobytes()


def _corpus(tmp_path, n=96):
    rng = np.random.default_rng(9)
    root = tmp_path / "corpus"
    root.mkdir()
    for i in range(n):
        row = rng.integers(0, 256, int(np.prod(R.CARD_SHAPE)),
                           dtype=np.uint8)
        label = int(row[:96].mean() > row[96:].mean())
        (root / f"{i:04d}_{label}_.bin").write_bytes(row.tobytes())
    return str(root)


@pytest.mark.cuda
def test_meshed_run_dataset_with_k1_on_each_rank(pool, tmp_path):
    corpus = _corpus(tmp_path)
    rng = np.random.default_rng(1)
    init = {"weight": rng.normal(0, 0.05, (2, 192)).astype(np.float32),
            "bias": np.zeros(2, np.float32)}
    whole, cut = str(tmp_path / "whole"), str(tmp_path / "cut")
    os.makedirs(whole)
    os.makedirs(cut)
    want = pool.run("torch_input_ranks:run_dataset", DATA2, corpus, whole,
                    20, 8, init, None, True)
    for w in want:
        assert w["launches"]["fused_normalize"] == 20
        assert sum(w["launches"].values()) == 20
    killed = pool.run("torch_input_ranks:run_dataset", DATA2, corpus, cut,
                      20, 8, init, 13, True)
    assert [k["params"] for k in killed] == [None, None]
    got = pool.run("torch_input_ranks:run_dataset", DATA2, corpus, cut, 20,
                   8, init, None, True)
    assert [g["resumed"] for g in got] == [10, 10]
    for g, w in zip(got, want):
        assert g["launches"]["fused_normalize"] == 10
        assert {"data_state-10.p0.json", "data_state-10.p1.json"} <= \
            set(g["data_states"])
        for k, v in w["params"].items():
            assert g["params"][k].tobytes() == v.tobytes(), k
