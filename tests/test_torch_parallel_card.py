"""Pipelines, expert banks and row-sharded tables on the card.

Runs only on a CUDA card (``cuda`` marker; skipped here) and imports no
JAX, so it runs on the card's machine with ``python -m pytest
--noconftest -p no:cacheprovider -m cuda tests/test_torch_parallel_card.py``.
Two ranks share the card over gloo (functions in
``tests/torch_parallel_ranks.py``), fp32 with TF32 off. Tolerances: the
fused lookup and the sparse gradient BIT-equal to the unsharded
references on the card; the pipeline within 1e-5 of the sequential
stack; the expert-split MoE LM's logits within 1e-5 of one rank's.
"""
import os

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.embed.tables import (_reference_table_grad,
                                             bag_lookup_reference)
from mmlspark_tpu_torch.testing.ranks import RankPool

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def pool(card):
    with RankPool(2, paths=[TESTS, REPO], env={
            "MMLSPARK_TPU_TORCH_RUNTIME_DEVICE": "cuda"}) as p:
        yield p


@pytest.mark.cuda
def test_sparse_scatter_adds_repeated_ids_in_batch_order(card):
    """``index_put_(accumulate=True)`` on the card adds a row's repeated
    updates in the order of the batch, as the CPU's ``index_add_``: the
    two table gradients are bit-equal."""
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(1, 16, (512, 4)))
    w = torch.ones(512, 4)
    g = torch.from_numpy(rng.normal(size=(512, 8)).astype(np.float32))
    cpu = _reference_table_grad(16, ids, w, g)
    gpu = _reference_table_grad(16, ids.to(card), w.to(card), g.to(card))
    assert torch.equal(gpu.cpu(), cpu)


@pytest.mark.cuda
def test_fused_lookup_and_sparse_grad_on_two_ranks(pool, card):
    rng = np.random.default_rng(1)
    table = rng.normal(size=(4096, 16)).astype(np.float32)
    table[0] = 0
    ids = rng.integers(0, 4096, (256, 4)).astype(np.int64)
    w = (ids != 0).astype(np.float32)
    gbags = rng.normal(size=(256, 16)).astype(np.float32)
    args = [torch.from_numpy(a).to(card) for a in (table, ids, w)]
    want = bag_lookup_reference(*args).cpu().numpy()
    want_grad = _reference_table_grad(4096, args[1], args[2],
                                      torch.from_numpy(gbags).to(card))
    for r in pool.run("torch_parallel_ranks:card_embed", table, ids, w,
                      gbags):
        assert np.array_equal(r["bags"], want)
        assert np.array_equal(r["grad"], want_grad.cpu().numpy())


@pytest.mark.cuda
def test_pipeline_on_two_ranks_sharing_the_card(pool, card):
    rng = np.random.default_rng(2)
    stacked = {"w1": rng.normal(0, 0.1, (4, 64, 128)).astype(np.float32),
               "b1": np.zeros((4, 128), np.float32),
               "w2": rng.normal(0, 0.1, (4, 128, 64)).astype(np.float32)}
    x = rng.normal(size=(16, 64)).astype(np.float32)
    t = {k: torch.from_numpy(v).to(card).requires_grad_()
         for k, v in stacked.items()}
    out = torch.from_numpy(x).to(card)
    for i in range(4):
        out = out + torch.tanh(out @ t["w1"][i] + t["b1"][i]) @ t["w2"][i]
    (out ** 2).mean().backward()
    for r in pool.run("torch_parallel_ranks:card_pipe", stacked, x, 4):
        np.testing.assert_allclose(r["out"], out.detach().cpu().numpy(),
                                   atol=1e-5, rtol=0)
        for k, v in t.items():
            np.testing.assert_allclose(r["grads"][k], v.grad.cpu().numpy(),
                                       atol=1e-5, rtol=0, err_msg=k)
        assert r["host_copies"] > 0          # gloo's hops via the host


@pytest.mark.cuda
def test_moe_lm_split_over_expert_on_two_ranks(pool, card):
    from mmlspark_tpu_torch.models.zoo import build_model, init_state
    arch = dict(vocab=64, max_len=32, num_experts=4, capacity_factor=0.5)
    module = build_model("transformer_lm_moe_tiny", **arch)["module"]
    params = init_state(module, 0)
    module.load_state_dict({k: torch.from_numpy(v)
                            for k, v in params.items()})
    tokens = np.random.default_rng(3).integers(0, 64, (4, 32))
    with torch.no_grad():
        want = module.to(card)(torch.from_numpy(tokens).to(card)).cpu()
    for r in pool.run("torch_parallel_ranks:card_moe", params, tokens, arch):
        assert r["experts"] == 2
        np.testing.assert_allclose(r["logits"], want.numpy(), atol=1e-5,
                                   rtol=0)
