"""Ulysses attention with K3 on two ranks that share one card (gloo).

Runs only on a CUDA card (``cuda`` marker; skipped here) and imports no
JAX, so it runs on the card's machine with
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_mesh_card.py``. Each rank holds half the sequence, the
all-to-all hands it every position of half the heads, and K3's
tensor-core route runs on the rank's (B, L, H/2, D) bf16 heads. The
gathered output is held against the one-rank plain version (the
reference attention, fp32 softmax) by K3's tensor-core gate
(``chip_smoke.py``): |difference| at most 2^-8 max|v| + 2e-5 + one bf16
step of the output, the mean at most 2^-8 of the mean |output| (the
route rounds p to bf16).
"""
import os

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.parallel.sequence import full_attention
from mmlspark_tpu_torch.testing.ranks import RankPool

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
B, L, H, D = 2, 1024, 8, 64


@pytest.fixture(scope="module")
def pool():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with RankPool(2, paths=[TESTS, REPO], env={
            "MMLSPARK_TPU_TORCH_RUNTIME_DEVICE": "cuda"}) as p:
        yield p


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_with_k3_on_two_ranks_sharing_the_card(pool, causal):
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(0, 1, (B, L, H, D)).astype(np.float32)
               for _ in range(3))
    ranks = pool.run("torch_mesh_ranks:card_ulysses", q, k, v, causal)
    card = torch.device("cuda", 0)
    qb, kb, vb = (torch.from_numpy(x).to(card).to(torch.bfloat16)
                  for x in (q, k, v))
    want = full_attention(qb, kb, vb, causal=causal,
                          use_flash="never").float().cpu().numpy()
    vmax = float(np.abs(vb.float().cpu().numpy()).max())
    step = 2.0 ** -7 * np.abs(want).max()
    for r in ranks:
        assert r["launches"]["flash_attention_tc"] == 1
        assert r["launches"]["flash_attention"] == 0
        diff = np.abs(r["out"] - want)
        assert diff.max() <= 2.0 ** -8 * vmax + 2e-5 + step, diff.max()
        assert diff.mean() <= 2.0 ** -8 * np.abs(want).mean(), diff.mean()
        np.testing.assert_array_equal(r["out"], ranks[0]["out"])
