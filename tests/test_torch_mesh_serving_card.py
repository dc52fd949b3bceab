"""Meshed scoring on two ranks that share one card (gloo), against one rank.

Runs only on a CUDA card (``cuda`` marker; skipped here) and imports no
JAX, so it runs on the card's machine with
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_mesh_serving_card.py``. Rank 0 leads
(``parallel/leader.py``) and scores ``transformer_lm`` at the zoo's width
(depth 2, fp32, TF32 off) at tensor 2, rank 1 following; each rank runs
K3's fp32 kernel on its four heads once a block. The logits are held to
rank 0's own one-rank pass within 1e-5 (the split layers' partial sums
are added in another order; ``chip_smoke.py``'s ``MESH_SERVE_F32_TOL``).
"""
import os

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.testing.ranks import RankPool

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
DEPTH = 2


@pytest.fixture(scope="module")
def pool():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with RankPool(2, paths=[TESTS, REPO], env={
            "MMLSPARK_TPU_TORCH_RUNTIME_DEVICE": "cuda"}) as p:
        yield p


@pytest.mark.cuda
def test_meshed_lm_score_equals_one_rank_in_fp32(pool):
    ids = np.random.default_rng(0).integers(0, 32000, (2, 512)).astype(
        np.int32)
    res = pool.run("torch_serve_ranks:card_lm_score", ids, DEPTH)[0]
    assert res["mesh"].shape == res["one"].shape == (2, 512, 32000)
    np.testing.assert_allclose(res["mesh"], res["one"], rtol=0, atol=1e-5)
    for counts in res["launches"]:
        assert counts["flash_attention"] == DEPTH
        assert counts["flash_attention_tc"] == 0
