"""The serving and generate programs on a card: one CUDA graph per bucket,
served rows equal to the eager apply at the same bucket, and kernel
launches accounted across graph replays.

This file imports no JAX, so the tests marked ``cuda`` run on a card's
machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_serve_card.py

Here, without a card, they skip. Tolerances are stated at each test.
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu_torch import kernels
from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.serve import Server, programs
from mmlspark_tpu_torch.utils import config as tconfig

pytestmark = pytest.mark.cuda

_GEN = {"generate.max_seq_len": 1024, "generate.max_sequences": 4,
        "generate.kv_block_tokens": 16}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tconfig.set("runtime.device", "cuda")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for k, v in _GEN.items():
        tconfig.set(k, v)
    yield torch.device("cuda", 0)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    for k in list(_GEN) + ["runtime.device"]:
        tconfig.unset(k)


def _lm(dtype="bfloat16", **kw):
    """A small LM whose 512-token rows reach K3 (L >= 512, a multiple of
    256): bf16 takes the tensor-core route, fp32 the CUDA-core route."""
    return TorchModel(inputCol="ids", outputCol="h", outputNodeName="hidden",
                      miniBatchSize=2).set_model(
        "transformer_lm_tiny", seed=0, max_len=1024, dtype=dtype, **kw)


def test_one_graph_per_bucket_and_served_equals_eager(card):
    """Served rows are bit-equal to the eager apply on the same padded
    batch: the graph replays the kernels the eager call launches."""
    m = TorchModel(inputCol="x", outputCol="y", miniBatchSize=8)
    m.set_model("mlp_tabular", input_dim=8, hidden=[64], num_classes=3,
                seed=0)
    rng = np.random.default_rng(0)
    with Server({"mlp": m}, max_batch=8, max_wait_ms=1.0,
                buckets=(1, 4, 8)) as srv:
        for rows in [1, 3, 8, 2, 1, 7, 4] * 3:
            x = rng.normal(size=(rows, 8)).astype(np.float32)
            got = srv.submit("mlp", x, timeout=60)
            entry = srv.registry.get("mlp")
            bucket = min(b for b in (1, 4, 8) if b >= rows)
            pad = np.zeros((bucket, 8), np.float32)
            pad[:rows] = x
            with torch.inference_mode():
                want = entry.ensure_apply()(
                    torch.from_numpy(pad).to(card)).float().cpu().numpy()
            assert np.array_equal(got, want[:rows])
        progs = entry.built_programs()
        assert entry.compile_count == len(progs) == 3
        assert all(isinstance(p, programs.GraphProgram)
                   for p in progs.values())


@pytest.mark.parametrize("dtype,kernel", [("bfloat16", "FLASH_ATTENTION_TC"),
                                          ("float32", "FLASH_ATTENTION")])
def test_replayed_k3_launches_are_accounted(card, dtype, kernel):
    """Each replay adds the launches its capture recorded: depth (2) K3
    launches of the dtype's route per 512-token batch, none at capture."""
    k3 = getattr(kernels, kernel)
    ids = np.random.default_rng(1).integers(0, 256, (6, 512)).astype(
        np.int32)
    with Server({"lm": _lm(dtype)}, max_batch=2, buckets=(1, 2)) as srv:
        entry = srv.registry.get("lm")
        kernels.reset_launches()
        prog = entry.program_for(2, ids[:2])          # capture: no launch
        assert prog.launches == {k3.name: (2, {})}
        assert k3.launches == 2                       # the eager warm-up
        kernels.reset_launches()
        for i in range(0, 6, 2):
            srv.submit("lm", ids[i:i + 2], timeout=120)
        assert prog.replays == 3
        assert {k.name: k.launches for k in kernels.KERNELS} == {
            k.name: (6 if k is k3 else 0) for k in kernels.KERNELS}
        with torch.inference_mode():
            want = entry.ensure_apply()(
                torch.from_numpy(ids[4:6]).to(card)).float().cpu().numpy()
        got = srv.submit("lm", ids[4:6], timeout=120)
        assert np.array_equal(got, want)


def test_generate_lane_graphs_and_tokens_equal_the_full_recompute(card):
    """fp32, TF32 off: greedy tokens equal the full-recompute loop; the
    prefill graph at bucket 512 replays K3's CUDA-core kernel once per
    layer; one graph per (kind, bucket), none in steady state."""
    srv = Server({"lm": TorchModel().set_model(
        "transformer_lm_tiny", seed=0, max_len=1024)}, start=False)
    try:
        lane = srv.enable_generate("lm", start=False)
        rng = np.random.default_rng(2)
        prompts = [list(rng.integers(0, 256, n)) for n in (300, 500, 40)]
        futs = [srv.submit_generate("lm", p, max_new_tokens=8)
                for p in prompts]
        kernels.reset_launches()
        for _ in range(64):
            if all(f.done() for f in futs):
                break
            lane.step()
        module = srv.registry.get("lm").module
        for p, f in zip(prompts, futs):
            toks = list(p)
            with torch.no_grad():
                for _ in range(8):
                    lg = module(torch.tensor([toks], device=card))
                    toks.append(int(lg[0, -1].argmax()))
            assert f.result(1)["tokens"] == toks[len(p):]
        progs = lane.gen.built_programs()
        assert all(isinstance(p, programs.GraphProgram)
                   for p in progs.values())
        assert progs[("prefill", 512)].launches == {
            kernels.FLASH_ATTENTION.name: (2, {})}
        assert progs[("prefill", 64)].launches == {}
        # new prompts of the same buckets (the same prompts would hit the
        # prefix cache and take the chunk program)
        before = lane.gen.entry.compile_count
        futs = [srv.submit_generate("lm", list(rng.integers(0, 256, n)),
                                    max_new_tokens=4) for n in (300, 500, 40)]
        for _ in range(64):
            if all(f.done() for f in futs):
                break
            lane.step()
        assert lane.gen.entry.compile_count == before
    finally:
        srv.close()


def test_a_capture_that_fails_raises(card):
    """No eager fallback on the card: a program whose function syncs the
    host cannot be captured, and building it raises."""
    def syncing(x):
        return x * float(x.sum().item())
    with pytest.raises(RuntimeError):
        programs.build(syncing, [((4,), torch.float32)], card)
