"""The port's generate lane (``mmlspark_tpu_torch/serve/{generate,kvcache}.py``)
against the JAX package's.

The host parts are copies and must agree exactly: the chained prefix
hashes, the block ledger under a seeded operation schedule (block tables,
refcounts, free list, cached pool, prefix index), the seeded sampler, the
bucket ladder. The device parts run ``transformer_lm_tiny`` (fp32) with
the JAX model's weights (``from_jax_params``) on the CPU, manually stepped
(``Server(start=False)`` + ``lane.step()``; no threads, no sleeps): greedy
tokens must equal the JAX lane's and the port's own full-recompute loop,
token for token. The paged decode sums its attention over the block
table's key slots where the full forward sums over the sequence, so
logits differ in the last fp32 bits; the argmax does not move on these
inputs.
"""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mmlspark_tpu.models.jax_model import JaxModel
from mmlspark_tpu.serve import Server as JServer
from mmlspark_tpu.serve import generate as jgenerate
from mmlspark_tpu.serve import kvcache as jkvcache
from mmlspark_tpu.utils import config as jconfig
from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.observability import metrics
from mmlspark_tpu_torch.serve import Server, ServerClosed, ServerOverloaded
from mmlspark_tpu_torch.serve import generate as tgenerate
from mmlspark_tpu_torch.serve.generate import (
    ContinuousBatcher, GenerateRequest, _Seq, parse_prefill_buckets,
    sample_token,
)
from mmlspark_tpu_torch.serve.http import serve_http
from mmlspark_tpu_torch.serve.kvcache import (
    RESERVED_BLOCK, KVCacheManager, blocks_needed, prefix_block_hashes,
)
from mmlspark_tpu_torch.utils import config as tconfig

_LANE = {"generate.max_seq_len": 64, "generate.max_sequences": 4,
         "generate.kv_block_tokens": 8}
_KEYS = tuple(_LANE) + (
    "generate.arena_mb", "generate.prefix_cache", "generate.prefill_chunk",
    "generate.kv_dtype", "generate.draft_model", "generate.prefill_buckets")

SYSTEM = [7, 3, 11, 19, 2, 5, 13, 17, 23, 29, 4, 8, 15, 16, 42, 99,
          31, 37, 41, 43, 47, 53, 59, 61]          # 3 full blocks at bt=8


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


_JAX_PARAMS = {}


def _jax_lm(seed=0):
    if seed not in _JAX_PARAMS:
        _JAX_PARAMS[seed] = JaxModel().set_model(
            "transformer_lm_tiny", seed=seed)._state["params"]
    return JaxModel().set_model("transformer_lm_tiny",
                                params=_JAX_PARAMS[seed])


def make_lm(seed=0):
    """The port's TorchModel on the JAX tiny LM's weights."""
    _jax_lm(seed)
    return TorchModel().set_model("transformer_lm_tiny",
                                  params=_JAX_PARAMS[seed])


def _run_lane(lane, futs, max_steps=96):
    for _ in range(max_steps):
        if all(f.done() for f in futs):
            break
        lane.step()
    return [f.result(1) for f in futs]


def _reference_greedy(srv, model, prompt, max_new):
    """The port's full-recompute loop: the whole context through the
    served module once per token."""
    module = srv.registry.get(model).module
    toks = list(prompt)
    with torch.no_grad():
        for _ in range(max_new):
            logits = module(torch.tensor([toks], dtype=torch.int64))
            toks.append(int(torch.argmax(logits[0, -1])))
    return toks[len(prompt):]


def _lane(srv, model="lm"):
    return srv.enable_generate(model, start=False)


# -- host parts equal the reference ------------------------------------------

@pytest.mark.parametrize("n,bt,dtype", [(0, 8, "float32"), (7, 8, "float32"),
                                        (24, 8, "float32"),
                                        (50, 16, "bfloat16"),
                                        (1024, 16, "bfloat16")])
def test_prefix_block_hashes_equal_the_reference(n, bt, dtype):
    prompt = np.random.default_rng(n).integers(0, 32000, n)
    assert prefix_block_hashes("lm", dtype, prompt, bt) \
        == jkvcache.prefix_block_hashes("lm", dtype, prompt, bt)


def _ledger(kv):
    with kv._lock:
        return (dict(kv._leases), dict(kv._refcount), list(kv._free),
                list(kv._cached.items()), dict(kv._index),
                dict(kv._block_hash), kv.prefix_hits, kv.prefix_misses,
                kv.cow_copies, kv.prefix_evictions)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_block_ledger_equals_the_reference_under_a_seeded_schedule(seed):
    """The reference's conservation fuzz schedule (join with prefix
    hashes, copy-on-write, diverging writes, finishes and kills) applied
    to both ledgers: every return value and the whole ledger agree after
    every operation."""
    rng = np.random.default_rng(seed)
    bt = 4
    kw = dict(layers=1, heads=1, head_dim=2, num_blocks=12, block_tokens=bt)
    port, ref = KVCacheManager(**kw), jkvcache.KVCacheManager(**kw)
    prompts = [list(rng.integers(0, 50, size=n)) for n in (4, 8, 8, 12, 6)]
    live = []
    next_id = 0
    for _ in range(300):
        op = rng.integers(0, 10)
        if op < 4 or not live:
            p = prompts[int(rng.integers(0, len(prompts)))]
            h = prefix_block_hashes("m", "float32", p, bt)
            sid = f"s{next_id}"
            tokens = len(p) + int(rng.integers(1, 9))
            got = [kv.try_reserve(sid, tokens, prefix_hashes=h,
                                  prompt_tokens=len(p)) for kv in (port, ref)]
            assert got[0] == got[1]
            if got[0] is not None:
                next_id += 1
                live.append(sid)
                cows = [kv.take_pending_cow(sid) for kv in (port, ref)]
                assert cows[0] == cows[1]
                for kv in (port, ref):
                    if cows[0] is not None:
                        kv.cow_done(sid)
                    kv.register_prefix(sid, h)
        elif op < 7:
            sid = live[int(rng.integers(0, len(live)))]
            bi = int(rng.integers(0, len(port.blocks_for(sid))))
            got = []
            for kv in (port, ref):
                try:
                    got.append(kv.prepare_write(sid, bi))
                except RuntimeError:
                    got.append("no block")
            assert got[0] == got[1]
        else:
            sid = live.pop(int(rng.integers(0, len(live))))
            assert port.free(sid) == ref.free(sid)
        assert _ledger(port) == _ledger(ref)
        assert port.check_conservation()
        assert port.resident_chains() == ref.resident_chains()


def test_kv_reserve_free_occupancy_and_block_table():
    kv = KVCacheManager(layers=2, heads=2, head_dim=4, num_blocks=5,
                        block_tokens=8)
    assert kv.free_blocks == 4 and kv.arena_k.shape == (2, 5, 8, 2, 4)
    got = kv.try_reserve("a", 17)
    assert len(got) == 3 and RESERVED_BLOCK not in got
    assert kv.try_reserve("b", 9) is None
    row = kv.block_table("a", 6)
    assert list(row[:3]) == got and list(row[3:]) == [RESERVED_BLOCK] * 3
    assert kv.free("a") == 3 and kv.free("a") == 0
    assert kv.occupancy() == 0.0 and blocks_needed(0, 8) == 1


@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.8, 0),
                                               (0.8, 2), (1.7, 5)])
@pytest.mark.parametrize("seed", [0, 7])
def test_sample_token_equals_the_reference(temperature, top_k, seed):
    logits = np.random.default_rng(seed).normal(size=64).astype(np.float32)
    for position in range(12):
        kw = dict(temperature=temperature, top_k=top_k, seed=seed,
                  position=position)
        assert sample_token(logits, **kw) \
            == jgenerate.sample_token(logits, **kw)


@pytest.mark.parametrize("text,max_len,bt", [("", 64, 8), ("", 2048, 16),
                                             ("8,32,64", 64, 8)])
def test_prefill_buckets_equal_the_reference(text, max_len, bt):
    assert parse_prefill_buckets(text, max_len, bt) \
        == jgenerate.parse_prefill_buckets(text, max_len, bt)
    with pytest.raises(ValueError):
        parse_prefill_buckets("0,8", 64, 8)


def test_continuous_batcher_joins_leaves_and_requeues():
    b = ContinuousBatcher(max_sequences=2)
    seqs = [_Seq(f"s{i}", GenerateRequest("m", [1, 2], 4), None, 0.0, None)
            for i in range(3)]
    for s in seqs:
        b.offer(s)
    taken = b.take()
    assert [s.seq_id for s in taken] == ["s0", "s1"]
    b.join(taken[0])
    b.requeue(taken[1])
    assert [s.seq_id for s in b.take()] == ["s1"]
    b.leave(taken[0])
    assert b.free_slots == 2 and len(b) == 1
    assert {s.seq_id for s in b.drain()} == {"s2"}


# -- the lane against the JAX lane and the full recompute ---------------------

def _jax_tokens(prompts, max_new):
    jsrv = JServer({"lm": _jax_lm()}, start=False)
    try:
        lane = jsrv.enable_generate("lm", start=False)
        futs = [jsrv.submit_generate("lm", p, max_new_tokens=max_new)
                for p in prompts]
        return [o["tokens"] for o in _run_lane(lane, futs)]
    finally:
        jsrv.close()


def test_greedy_tokens_equal_the_jax_lane_and_the_full_recompute():
    prompts = [[5, 9, 17, 3, 250], list(range(2, 29)), [200, 100]]
    want = _jax_tokens(prompts, 6)
    srv = Server({"lm": make_lm()}, start=False)
    try:
        lane = _lane(srv)
        futs = [srv.submit_generate("lm", p, max_new_tokens=6)
                for p in prompts]
        outs = _run_lane(lane, futs)
        for p, out, w in zip(prompts, outs, want):
            assert out["finish_reason"] == "length"
            assert out["tokens"] == w
            assert out["tokens"] == _reference_greedy(srv, "lm", p, 6)
    finally:
        srv.close()


def test_interleaved_sequences_match_solo_runs_and_free_their_blocks():
    srv = Server({"lm": make_lm()}, start=False)
    try:
        lane = _lane(srv)
        kv = lane.gen.kv
        idle = kv.free_blocks
        prompts = [[5, 9, 17], [1, 2, 3, 4, 5, 6, 7], [200, 100]]
        futs = [srv.submit_generate("lm", p, max_new_tokens=4 + i)
                for i, p in enumerate(prompts)]
        lane.step()
        assert kv.free_blocks < idle
        outs = _run_lane(lane, futs)
        for i, (p, out) in enumerate(zip(prompts, outs)):
            assert out["tokens"] == _reference_greedy(srv, "lm", p, 4 + i)
        assert kv.free_blocks == idle and kv.stats()["sequences"] == 0
        assert kv.check_conservation()
    finally:
        srv.close()


def test_sheds_retryable_when_the_arena_is_full():
    # 6 blocks of 8 tokens: one 25-token span (4 blocks) fits, two don't
    tconfig.set("generate.arena_mb", 0.05)
    srv = Server({"lm": make_lm()}, start=False)
    try:
        lane = _lane(srv)
        assert lane.gen.kv.free_blocks == 5
        f0 = srv.submit_generate("lm", [5] * 5, max_new_tokens=20)
        with pytest.raises(ServerOverloaded) as ei:
            srv.submit_generate("lm", [7] * 5, max_new_tokens=20)
        assert ei.value.retryable
        _run_lane(lane, [f0])
        f1 = srv.submit_generate("lm", [7] * 5, max_new_tokens=2)
        _run_lane(lane, [f1])
        assert lane.stats()["shed"] == 1
    finally:
        srv.close()


def test_one_program_per_kind_and_bucket_then_steady_state(monkeypatch):
    built = []
    orig = tgenerate.GenerativeEntry._compile

    def spy(self, kind, bucket):
        built.append((kind, bucket))
        return orig(self, kind, bucket)
    monkeypatch.setattr(tgenerate.GenerativeEntry, "_compile", spy)
    srv = Server({"lm": make_lm()}, start=False)
    try:
        lane = _lane(srv)
        entry = lane.gen.entry
        _run_lane(lane, [srv.submit_generate("lm", [5, 9, 17],
                                             max_new_tokens=3)])
        first = entry.compile_count
        assert first == len(built) >= 2      # a prefill and a decode bucket
        _run_lane(lane, [srv.submit_generate("lm", [8, 8, 8],
                                             max_new_tokens=3)])
        assert entry.compile_count == first  # steady state: none
        futs = [srv.submit_generate("lm", [i, 2, 3, 4], max_new_tokens=4)
                for i in range(4)]
        _run_lane(lane, futs)
        assert len(built) == len(set(built)), built
        assert srv.stats()["registry.compiles"] == len(built)
    finally:
        srv.close()


def test_shared_prefix_partial_hits_give_the_plain_tokens():
    srv = Server({"lm": make_lm()}, start=False)
    try:
        lane = _lane(srv)
        prompts = [SYSTEM + [100 + i, 200 + i, 55] for i in range(3)]
        outs = []
        for p in prompts:
            outs += _run_lane(lane, [srv.submit_generate(
                "lm", p, max_new_tokens=5)])
        for p, out in zip(prompts, outs):
            assert out["tokens"] == _reference_greedy(srv, "lm", p, 5)
        st = lane.stats()
        assert st["prefix_hits"] >= 6 and st["kv.used_blocks"] == 0
        assert [o["prefix_hits"] for o in outs] == [0, 3, 3]
    finally:
        srv.close()


def test_identical_prompt_full_hit_copies_on_write():
    srv = Server({"lm": make_lm()}, start=False)
    try:
        lane = _lane(srv)
        prompt = SYSTEM[:16]                       # block-aligned prompt
        out0, = _run_lane(lane, [srv.submit_generate(
            "lm", prompt, max_new_tokens=6)])
        out1, = _run_lane(lane, [srv.submit_generate(
            "lm", prompt, max_new_tokens=6)])
        assert out0["tokens"] == out1["tokens"] \
            == _reference_greedy(srv, "lm", prompt, 6)
        st = lane.stats()
        assert st["prefix_hits"] == 2 and st["cow_copies"] == 1
    finally:
        srv.close()


def test_prefix_cache_off_gives_the_same_tokens():
    tconfig.set("generate.prefix_cache", False)
    srv = Server({"lm": make_lm()}, start=False)
    try:
        lane = _lane(srv)
        futs = [srv.submit_generate("lm", SYSTEM + [i], max_new_tokens=4)
                for i in range(2)]
        outs = _run_lane(lane, futs)
        for i, out in enumerate(outs):
            assert out["tokens"] == _reference_greedy(
                srv, "lm", SYSTEM + [i], 4)
        assert lane.stats()["prefix_hits"] == 0
    finally:
        srv.close()


def test_chunked_prefill_gives_the_plain_tokens_and_interleaves():
    tconfig.set("generate.prefill_chunk", 8)
    tconfig.set("generate.prefix_cache", False)
    srv = Server({"lm": make_lm()}, start=False)
    try:
        lane = _lane(srv)
        short = [5, 9, 17]
        f0 = srv.submit_generate("lm", short, max_new_tokens=10)
        lane.step()
        long_p = list(range(2, 29))                # 27 tokens -> 4 chunks
        f1 = srv.submit_generate("lm", long_p, max_new_tokens=5)
        before = len(lane.batcher.active[0].generated)
        lane.step()
        assert lane.stats()["prefilling"] == 1
        assert len(lane.batcher.active[0].generated) > before
        outs = _run_lane(lane, [f0, f1])
        assert outs[0]["tokens"] == _reference_greedy(srv, "lm", short, 10)
        assert outs[1]["tokens"] == _reference_greedy(srv, "lm", long_p, 5)
    finally:
        srv.close()


def test_deadline_mid_decode_returns_the_partial_stream():
    clock = {"now": 0.0}
    srv = Server({"lm": make_lm()}, start=False)
    try:
        lane = srv.enable_generate("lm", start=False,
                                   clock=lambda: clock["now"])
        f = srv.submit_generate("lm", [5, 9, 17], max_new_tokens=20,
                                deadline_ms=10.0)
        lane.step()
        clock["now"] = 1.0
        lane.step()
        out = f.result(1)
        assert out["finish_reason"] == "deadline"
        assert 1 <= len(out["tokens"]) < 20
    finally:
        srv.close()


# -- the draft, int8 and verify paths; refusals; the HTTP route, close -------

def test_draft_model_int8_and_verify_build_and_run():
    """A draft model, an int8 arena and the verify program build and run
    through one lane: the draft entry has its own arena, the verify graph
    is keyed by its window, and the greedy tokens equal the full
    recompute (int8 moves values; these tiny-model tokens do not move)."""
    tconfig.set("generate.draft_model", "draft")
    tconfig.set("generate.kv_dtype", "int8")
    srv = Server({"lm": make_lm(), "draft": make_lm()}, start=False)
    try:
        lane = _lane(srv)
        assert lane.draft is not None and lane.gen.kv.quantized
        assert lane.draft.kv.quantized
        prompt = [5, 9, 17, 3, 250]
        f = srv.submit_generate("lm", prompt, max_new_tokens=6)
        out, = _run_lane(lane, [f])
        assert out["tokens"] == _reference_greedy(srv, "lm", prompt, 6)
        kinds = {k for k, _ in lane.gen.built_programs()}
        assert kinds == {"prefill", "verify"}
        assert {k for k, _ in lane.draft.built_programs()} \
            == {"prefill", "decode"}
        st = lane.stats()
        assert st["spec_accepted"] == st["spec_proposed"] > 0
        assert st["draft.kv.used_blocks"] == 0
    finally:
        srv.close()


def test_moe_lm_is_refused():
    m = TorchModel().set_model("transformer_lm_moe", seed=0, vocab=64,
                               dim=32, depth=2, heads=2, max_len=64,
                               num_experts=2, dtype="float32")
    srv = Server({"moe": m}, start=False)
    try:
        with pytest.raises(ValueError, match="MoE"):
            srv.enable_generate("moe", start=False)
    finally:
        srv.close()


def test_http_generate_roundtrip_and_close_fails_unfinished():
    with Server({"lm": make_lm()}) as srv:
        httpd, addr = serve_http(srv, port=0)
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        try:
            req = urllib.request.Request(
                f"http://{addr}/generate",
                data=json.dumps({"model": "lm", "prompt": [5, 9, 17],
                                 "max_new_tokens": 4}).encode())
            with urllib.request.urlopen(req, timeout=60) as r:
                out = json.loads(r.read())
            assert out["tokens"] == _reference_greedy(srv, "lm",
                                                      [5, 9, 17], 4)
            assert out["finish_reason"] == "length"
            bad = urllib.request.Request(
                f"http://{addr}/generate",
                data=json.dumps({"model": "lm", "prompt": []}).encode())
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(bad, timeout=60)
            assert ei.value.code == 400
        finally:
            httpd.shutdown()
            httpd.server_close()
            t.join(timeout=30)
    with Server({"lm": make_lm()}, start=False) as srv2:
        lane = _lane(srv2)
        f = srv2.submit_generate("lm", [5, 9, 17], max_new_tokens=4)
    with pytest.raises(ServerClosed):
        f.result(1)
    assert lane.gen.entry.kv_arena_bytes == 0
