"""Speculative decoding, int8 KV blocks and the in-process fleet on a card.

This file imports no JAX, so the tests marked ``cuda`` run on a card's
machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_spec_card.py

Here, without a card, they skip. fp32 with TF32 off throughout; the
tolerance of each check is stated at its test.
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.serve import Fleet, Server
from mmlspark_tpu_torch.serve.kvcache import dequantize_rows, quantize_rows
from mmlspark_tpu_torch.utils import config as tconfig

pytestmark = pytest.mark.cuda

_GEN = {"generate.max_seq_len": 256, "generate.max_sequences": 4,
        "generate.kv_block_tokens": 16, "fleet.affinity_prewarm": 0}
_UNSET = ("generate.draft_model", "generate.kv_dtype")


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
    for k in list(_GEN) + ["runtime.device", *_UNSET]:
        tconfig.unset(k)


def _lm(seed=0):
    return TorchModel().set_model("transformer_lm_tiny", seed=seed,
                                  max_len=256)


PROMPTS = [list(range(1, 40)), [5, 9, 17, 3, 250], list(range(60, 140)),
           [7] * 20]


def _run(srv, lane, prompts, n, **sample):
    futs = [srv.submit_generate("lm", p, max_new_tokens=n, **sample)
            for p in prompts]
    for _ in range(64 * n):
        if all(f.done() for f in futs):
            break
        lane.step()
    return [f.result(1)["tokens"] for f in futs]


def test_quantize_rows_round_trip_bounds_on_the_card(card):
    """On the card, each dequantized element lies within scale/2 of the
    element it stores, plus the fp32 rounding of x/scale and of q*scale
    (at |q| <= 127 together under 2**-15 of scale/2); the card's int8 rows
    and scales equal the CPU's bit for bit (IEEE fp32 division, round half
    to even)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((6, 64, 16, 8, 64))
         * rng.uniform(0.01, 20, (6, 64, 16, 1, 1))).astype(np.float32)
    xc = torch.from_numpy(x).to(card)
    q, s = quantize_rows(xc)
    err = (dequantize_rows(q, s) - xc).abs()
    assert bool((err <= s[..., None, None] / 2 * (1 + 2 ** -15)).all())
    qc, sc = quantize_rows(torch.from_numpy(x))
    assert torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc)


def test_int8_arena_rows_after_a_prefill_on_the_card(card):
    """The int8 arena's dequantized rows after a prefill lie within
    scale/2 (and the fp32 rounding above) of the fp32 arena's rows for the
    same prompt, in every leased block. Block 0 is scratch: each graph's
    eager warm-up writes it."""
    prompt = list(range(1, 100))
    arenas = {}
    for kv in ("", "int8"):
        tconfig.set("generate.kv_dtype", kv)
        srv = Server({"lm": _lm()}, start=False)
        try:
            lane = srv.enable_generate("lm", start=False)
            _run(srv, lane, [prompt], 1)
            kvm = lane.gen.kv
            arenas[kv] = (kvm.arena_k.clone(), kvm.scale_k)
        finally:
            srv.close()
    f = arenas[""][0][:, 1:]
    q, s = (t[:, 1:] for t in arenas["int8"])
    assert bool(((dequantize_rows(q, s) - f).abs()
                 <= s[..., None, None] / 2 * (1 + 2 ** -15)).all())


@pytest.mark.parametrize("draft_seed", [0, 3], ids=["same_weights",
                                                    "divergent"])
def test_spec_tokens_equal_plain_tokens_on_the_card(card, draft_seed):
    """fp32: greedy and seeded-sampling tokens with speculation EQUAL the
    plain lane's, through CUDA graphs (verify and the draft's decode)."""
    outs = {}
    for spec in (False, True):
        tconfig.set("generate.draft_model", "draft" if spec else "")
        models = {"lm": _lm()}
        if spec:
            models["draft"] = _lm(draft_seed)
        srv = Server(models, start=False)
        try:
            lane = srv.enable_generate("lm", start=False)
            outs[spec] = (_run(srv, lane, PROMPTS, 12),
                          _run(srv, lane, PROMPTS[:2], 12, temperature=0.8,
                               top_k=4, seed=1234))
            if spec:
                st = lane.stats()
                assert st["spec_proposed"] > 0
                kinds = {k for k, _ in lane.gen.built_programs()}
                assert "verify" in kinds and "decode" not in kinds
        finally:
            srv.close()
    assert outs[True] == outs[False]


def test_no_capture_after_warm_up_across_scale_up(card):
    """Captures happen at a replica's warm-up only: the founding replicas
    while warming, the scaled-up one inside ``scale_up``; traffic through
    the router afterwards captures nothing, and its tokens equal one
    Server's."""
    lm = _lm()
    ref = Server({"lm": lm}, start=False)
    try:
        lane = ref.enable_generate("lm", start=False)
        want = [_run(ref, lane, [p], 6)[0] for p in PROMPTS]
    finally:
        ref.close()
    with Fleet({"lm": lm}, replicas=2, failover_delay_s=0.0) as fleet:
        for rep in fleet.replicas:
            for p in PROMPTS * 2:
                rep.server.submit_generate("lm", p, 6).result(60)
        name = fleet.scale_up()
        warm = {r.name: r.server.registry.stats()["compiles"]
                for r in fleet.replicas}
        assert warm[name] == warm["r0"] > 0
        got = [fleet.submit_generate("lm", p, 6)["tokens"]
               for p in PROMPTS * 2]
        after = {r.name: r.server.registry.stats()["compiles"]
                 for r in fleet.replicas}
    assert after == warm
    assert got == want * 2
