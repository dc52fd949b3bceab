"""Speculative decoding and int8 KV blocks in the port's generate lane
(``mmlspark_tpu_torch/serve/{generate,kvcache}.py``) against the JAX
package's.

The quantization arithmetic is plain torch against plain jnp and must be
bit-equal: symmetric per-row absmax scales, ``round`` half to even. The
arena sizing is host arithmetic and must be equal. The lanes run
``transformer_lm_tiny`` cut to dim 32 (fp32, depth 2, ``max_seq_len`` 64,
blocks of 8) with the JAX model's weights (``from_jax_params``) on the CPU,
manually stepped: the tokens of the int8 lane, of the speculative lane
(a same-weights draft and a divergent one) and of seeded sampling must
equal the JAX lane's token for token, and the speculation counters must
equal the reference's on the same schedule. The port's paged attention
sums in another order than XLA's, so logits differ in the last fp32 bits;
on these inputs no argmax and no sampled token moves.
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu.models.jax_model import JaxModel
from mmlspark_tpu.serve import Server as JServer
from mmlspark_tpu.serve import kvcache as jkvcache
from mmlspark_tpu.utils import config as jconfig
from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.observability import metrics
from mmlspark_tpu_torch.serve import Server
from mmlspark_tpu_torch.serve.kvcache import (
    KVCacheManager, dequantize_rows, quantize_rows,
)
from mmlspark_tpu_torch.utils import config as tconfig

_LANE = {"generate.max_seq_len": 64, "generate.max_sequences": 4,
         "generate.kv_block_tokens": 8}
_KEYS = tuple(_LANE) + (
    "generate.arena_mb", "generate.prefix_cache", "generate.prefill_chunk",
    "generate.kv_dtype", "generate.draft_model", "generate.spec_tokens")
_ARCH = {"dim": 32}

SYSTEM = [7, 3, 11, 19, 2, 5, 13, 17, 23, 29, 4, 8, 15, 16, 42, 99,
          31, 37, 41, 43, 47, 53, 59, 61]          # 3 full blocks at bt=8
PROMPTS = [[5, 9, 17, 3, 250], [1, 2, 3, 4], [200, 100],
           SYSTEM + [77, 78], SYSTEM[:16]]


@pytest.fixture(autouse=True)
def _small_lane_config():
    prior = {k: jconfig.get(k) for k in _KEYS}
    tconfig.set("runtime.device", "cpu")
    for k, v in _LANE.items():
        tconfig.set(k, v)
        jconfig.set(k, v)
    metrics.get_registry().reset()
    yield
    for k, v in prior.items():
        jconfig.set(k, v)
    for k in _KEYS + ("runtime.device",):
        tconfig.unset(k)
    metrics.get_registry().reset()


def _both(key, value):
    tconfig.set(key, value)
    jconfig.set(key, value)


_PARAMS = {}


def _jax_params(seed):
    if seed not in _PARAMS:
        _PARAMS[seed] = JaxModel().set_model(
            "transformer_lm_tiny", seed=seed, **_ARCH)._state["params"]
    return _PARAMS[seed]


def jax_lm(seed=0):
    return JaxModel().set_model("transformer_lm_tiny",
                                params=_jax_params(seed), **_ARCH)


def torch_lm(seed=0):
    return TorchModel().set_model("transformer_lm_tiny",
                                  params=_jax_params(seed), **_ARCH)


def _drive(server_cls, make, prompts, max_new, *, draft=None, kv="",
           sequential=False, **sample):
    """Run ``prompts`` through a manually stepped lane of ``server_cls``
    (the port's or the JAX package's): (tokens per prompt, lane stats)."""
    _both("generate.draft_model", "draft" if draft is not None else "")
    _both("generate.kv_dtype", kv)
    models = {"lm": make(0)}
    if draft is not None:
        models["draft"] = make(draft)
    srv = server_cls(models, start=False)
    try:
        lane = srv.enable_generate("lm", start=False)
        groups = [[p] for p in prompts] if sequential else [prompts]
        out = []
        for group in groups:
            futs = [srv.submit_generate("lm", p, max_new_tokens=max_new,
                                        **sample) for p in group]
            for _ in range(256):
                if all(f.done() for f in futs):
                    break
                lane.step()
            out += [f.result(1)["tokens"] for f in futs]
        return out, lane.stats()
    finally:
        srv.close()


def _full_recompute(prompt, n, seed=0):
    module = torch_lm(seed)._device_apply(torch.device("cpu"))[0]
    toks = list(prompt)
    with torch.no_grad():
        for _ in range(n):
            logits = module(torch.tensor([toks], dtype=torch.int64))
            toks.append(int(torch.argmax(logits[0, -1])))
    return toks[len(prompt):]


_SPEC_KEYS = ("spec_proposed", "spec_accepted", "steps", "prefix_hits",
              "cow_copies")


# -- quantization arithmetic: bit-equal --------------------------------------

@pytest.mark.parametrize("shape", [(3, 8, 4, 16), (2, 5, 8, 64), (1, 1, 1, 1)])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_is_bit_equal_to_the_reference(shape, seed, dtype):
    """int8 rows and fp32 scales bit-equal (tolerance 0), rows of mixed
    magnitude and an all-zero row included; the dequantized rows too."""
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 30, shape[:-2] + (
        1, 1))).astype(np.float32)
    x[(0,) * (len(shape) - 2)] = 0.0
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(xt.float().numpy()).astype(dtype)
    q, s = quantize_rows(xt)
    jq, js = jkvcache.quantize_rows(xj)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        dequantize_rows(q, s).numpy(),
        np.asarray(jkvcache.dequantize_rows(jq, js)))


def test_quantize_rows_rounds_half_to_even_as_the_reference():
    """Rows whose values sit exactly on .5 steps of the scale: both round
    half to even (0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -0.5 -> 0)."""
    import jax.numpy as jnp
    row = np.array([[[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]]],
                   np.float32)
    q, s = quantize_rows(torch.from_numpy(row))
    jq, js = jkvcache.quantize_rows(jnp.asarray(row))
    assert float(s[0]) == 1.0
    assert q[0, 0].tolist() == [127, 0, 2, 2, 0, -2, -2, 4]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


# -- arena sizing: equal ------------------------------------------------------

@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, "float32"),
                                          (torch.bfloat16, "bfloat16")])
@pytest.mark.parametrize("geometry", [(2, 2, 16, 8), (6, 8, 64, 16)])
def test_int8_arena_sizing_equals_the_reference(dtype, jdtype, geometry):
    """At one ``generate.arena_mb``: num_blocks, arena_bytes and
    unquantized_arena_bytes equal the reference's (exact integers)."""
    import jax.numpy as jnp
    layers, heads, hd, bt = geometry
    _both("generate.kv_block_tokens", bt)
    _both("generate.arena_mb", 3.0)
    _both("generate.kv_dtype", "int8")
    q = KVCacheManager.from_config(layers=layers, heads=heads, head_dim=hd,
                                   dtype=dtype)
    jq = jkvcache.KVCacheManager.from_config(
        layers=layers, heads=heads, head_dim=hd,
        dtype=np.dtype(getattr(jnp, jdtype)))
    assert q.quantized and jq.quantized
    assert (q.num_blocks, q.arena_bytes(), q.unquantized_arena_bytes()) == (
        jq.num_blocks, jq.arena_bytes(), jq.unquantized_arena_bytes())
    assert q.scale_k.shape == (layers, q.num_blocks, bt)
    assert q.stats()["kv_dtype"] == jq.stats()["kv_dtype"] == "int8"


def test_int8_arena_capacity_at_the_zoo_width():
    """The zoo LM's width (H=8, D=64, blocks of 16): a token row costs 516
    B in int8 (512 + a 4-byte scale) against 1024 in bf16 and 2048 in
    fp32, so one ``arena_mb`` holds 1.98x the bf16 blocks and 3.97x the
    fp32 ones (the reference's bar: >= 1.8x over fp32)."""
    _both("generate.kv_block_tokens", 16)
    _both("generate.arena_mb", 201.5)
    counts = {}
    for kv, dt in (("", torch.float32), ("", torch.bfloat16),
                   ("int8", torch.bfloat16)):
        tconfig.set("generate.kv_dtype", kv)
        counts[(kv, dt)] = KVCacheManager.from_config(
            layers=1, heads=8, head_dim=64, dtype=dt).num_blocks * 6
    int8 = counts[("int8", torch.bfloat16)]
    assert int8 / counts[("", torch.bfloat16)] == pytest.approx(1024 / 516,
                                                                rel=1e-3)
    assert int8 / counts[("", torch.float32)] == pytest.approx(2048 / 516,
                                                               rel=1e-3)


# -- the int8 lane -----------------------------------------------------------

@pytest.mark.parametrize("chunk", [0, 8])
def test_int8_lane_tokens_equal_the_jax_int8_lane(chunk):
    """Greedy tokens of the int8 lane equal the JAX int8 lane's, with
    prefix hits, a copy-on-write (scale planes copied) and, at chunk 8,
    chunked prefill; the prefix counters equal too."""
    _both("generate.prefill_chunk", chunk)
    got, st = _drive(Server, torch_lm, PROMPTS, 6, kv="int8",
                     sequential=True)
    want, jst = _drive(JServer, jax_lm, PROMPTS, 6, kv="int8",
                       sequential=True)
    assert got == want
    assert st["kv.quantized"] == 1.0 and st["cow_copies"] >= 1
    assert {k: st[k] for k in _SPEC_KEYS} == {k: jst[k] for k in _SPEC_KEYS}


def test_int8_arena_rows_lie_within_half_a_scale_of_the_fp32_rows():
    """After a prefill, every dequantized element of the int8 arena's
    leased blocks lies within scale/2 of the fp32 arena's element for the
    same prompt, plus the fp32 rounding of x/scale and of q*scale (at
    |q| <= 127 together under 2**-15 of scale/2). Block 0 is scratch."""
    prompt = SYSTEM + [77, 78, 79]
    arenas = {}
    for kv in ("", "int8"):
        tconfig.set("generate.kv_dtype", kv)
        srv = Server({"lm": torch_lm()}, start=False)
        try:
            lane = srv.enable_generate("lm", start=False)
            srv.submit_generate("lm", prompt, max_new_tokens=1)
            lane.step()
            kvm = lane.gen.kv
            arenas[kv] = (kvm.arena_k.clone(), kvm.arena_v.clone(),
                          kvm.scale_k, kvm.scale_v)
        finally:
            srv.close()
    fk, fv = arenas[""][:2]
    qk, qv, sk, sv = arenas["int8"]
    for f, q, s in ((fk, qk, sk), (fv, qv, sv)):
        f, q, s = f[:, 1:], q[:, 1:], s[:, 1:]
        deq = dequantize_rows(q, s)
        bound = s[..., None, None] / 2 * (1 + 2 ** -15)
        assert bool(((deq - f).abs() <= bound).all())
        assert float(s.min()) < 1.0         # rows were written


# -- speculative decoding ----------------------------------------------------

@pytest.mark.parametrize("draft_seed", [0, 3], ids=["same_weights",
                                                    "divergent"])
@pytest.mark.parametrize("kv", ["", "int8"])
def test_spec_tokens_and_counters_equal_the_jax_spec_lane(draft_seed, kv):
    """Greedy tokens with speculation equal the JAX spec lane's and (fp32)
    the full recompute; spec_proposed / spec_accepted / steps equal the
    reference's on the same schedule."""
    got, st = _drive(Server, torch_lm, PROMPTS, 8, draft=draft_seed, kv=kv)
    want, jst = _drive(JServer, jax_lm, PROMPTS, 8, draft=draft_seed, kv=kv)
    assert got == want
    assert {k: st[k] for k in _SPEC_KEYS} == {k: jst[k] for k in _SPEC_KEYS}
    assert st["spec_proposed"] > 0
    if kv == "":
        assert got == [_full_recompute(p, 8) for p in PROMPTS]
    assert st["draft.kv.used_blocks"] == 0


def test_same_weights_draft_accepts_a_whole_first_window():
    """The first window after prefill is fully accepted by a same-weights
    draft (3 of 3). After a fully accepted window the reference's draft has
    never fed its last proposal, so its arena lacks that position's K/V
    and later proposals can miss: the whole-run rate stays below 1.0 in
    the reference and the port alike (24 of 26 on ``PROMPTS``, equal to
    the reference's counters in the test above)."""
    _, st = _drive(Server, torch_lm, PROMPTS[:1], 5, draft=0)
    assert st["spec_proposed"] == st["spec_accepted"] == 3
    _, st = _drive(Server, torch_lm, PROMPTS, 8, draft=0)
    assert (st["spec_accepted"], st["spec_proposed"]) == (24, 26)


@pytest.mark.parametrize("spec_tokens", [1, 5])
def test_spec_window_widths_equal_the_reference(spec_tokens):
    """The verify window follows ``generate.spec_tokens``: tokens and
    counters equal the reference's at each width."""
    _both("generate.spec_tokens", spec_tokens)
    got, st = _drive(Server, torch_lm, PROMPTS[:3], 7, draft=0)
    want, jst = _drive(JServer, jax_lm, PROMPTS[:3], 7, draft=0)
    assert got == want
    assert {k: st[k] for k in _SPEC_KEYS} == {k: jst[k] for k in _SPEC_KEYS}


@pytest.mark.parametrize("draft_seed", [0, 3])
def test_seeded_sampling_replays_with_and_without_speculation(draft_seed):
    """temperature 0.8, top_k 4, seed 1234: the same tokens with and
    without speculation, equal to the JAX lane's."""
    sample = dict(temperature=0.8, top_k=4, seed=1234)
    plain, _ = _drive(Server, torch_lm, PROMPTS[:2], 8, **sample)
    spec, st = _drive(Server, torch_lm, PROMPTS[:2], 8, draft=draft_seed,
                      **sample)
    want, _ = _drive(JServer, jax_lm, PROMPTS[:2], 8, draft=draft_seed,
                     **sample)
    assert plain == spec == want
    assert st["spec_proposed"] > 0


def test_draft_side_prefix_reuse_counter_equals_the_reference():
    """The second sequence over the system prompt re-leases the draft's
    cached blocks (``draft_prefix_hits``), as the reference counts them,
    and the tokens still equal."""
    prompts = [SYSTEM + [77], SYSTEM + [88, 89]]
    got, st = _drive(Server, torch_lm, prompts, 4, draft=0, sequential=True)
    want, jst = _drive(JServer, jax_lm, prompts, 4, draft=0,
                       sequential=True)
    assert got == want
    assert st["draft_prefix_hits"] == jst["draft_prefix_hits"] >= 3
    assert st["draft_prefix_hits"] <= st["prefix_hits"]


def test_speculation_turns_off_when_the_draft_arena_sheds():
    """The draft reservation is best-effort: with the draft arena full the
    sequence decodes unspeculated (spec_proposed 0) instead of shedding."""
    _both("generate.draft_model", "draft")
    srv = Server({"lm": torch_lm(), "draft": torch_lm()}, start=False)
    try:
        lane = srv.enable_generate("lm", start=False)
        d = lane.draft.kv
        assert d.try_reserve("hog", d.free_blocks * d.block_tokens)
        assert d.free_blocks == 0
        f = srv.submit_generate("lm", [5, 9, 17], max_new_tokens=4)
        for _ in range(16):
            if f.done():
                break
            lane.step()
        assert f.result(1)["tokens"] == _full_recompute([5, 9, 17], 4)
        assert lane.stats()["spec_proposed"] == 0
        assert lane.stats()["shed"] == 0
        d.free("hog")
    finally:
        srv.close()


def test_verify_is_one_program_per_bucket_keyed_by_its_window(monkeypatch):
    """Each (kind, bucket) builds once through the compile seam; the
    verify graph's shape key carries ``|C=spec_tokens+1``; a second round
    builds nothing."""
    from mmlspark_tpu_torch import compile_cache
    keys = []
    real = compile_cache.load_or_compile_program

    def spy(model, version, kind, shape_key, fresh):
        keys.append((model, kind, shape_key))
        return real(model, version, kind, shape_key, fresh)
    monkeypatch.setattr(compile_cache, "load_or_compile_program", spy)
    _both("generate.draft_model", "draft")
    srv = Server({"lm": torch_lm(), "draft": torch_lm(3)}, start=False)
    try:
        lane = srv.enable_generate("lm", start=False)
        rounds = []
        for _ in range(2):
            futs = [srv.submit_generate("lm", p, max_new_tokens=5)
                    for p in PROMPTS[:3]]
            for _ in range(64):
                if all(f.done() for f in futs):
                    break
                lane.step()
            rounds.append(list(keys))
        assert rounds[0] == rounds[1] and len(keys) == len(set(keys))
        verify = [k for k in keys if k[1] == "verify"]
        assert verify and all(k[0] == "lm" and k[2].endswith("|C=4")
                              for k in verify)
        assert any(k[0] == "draft" and k[1] == "decode" for k in keys)
    finally:
        srv.close()
