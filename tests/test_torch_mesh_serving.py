"""Serving on a mesh in the port against the JAX package, on the CPU.

The port's ranks are gloo processes of one module-scoped pool per world
size (``mmlspark_tpu_torch.testing.ranks.RankPool``): rank 0 leads
(``parallel/leader.py``: it owns the model, the ``Server``, the ``Fleet``)
and the others follow; their functions are in
``tests/torch_serve_ranks.py``, which imports no JAX. Each test restates a
reference test of meshed scoring or serving, with worlds of at most 4
ranks where the reference used 8 devices, and holds the port's meshed
answers to the JAX package's on the same weights (``from_jax_params``):

- scores: rtol/atol 1e-5 (mlp_tabular), 1e-3 (the LM over a split
  sequence), 1e-4 (vit_tiny, its featurizer), as the reference tests hold
  their meshed scores to one device;
- greedy decode: tokens equal to the JAX lane's;
- the recommender and the fleet: bit-equal to the port's one-device
  answers (the reference's bit-identity), and within 1e-5 of the JAX
  package's.
"""
import json
import os

import jax
import numpy as np
import pytest

from mmlspark_tpu.core.frame import Frame as JFrame
from mmlspark_tpu.models.jax_model import JaxModel
from mmlspark_tpu.serve import Server as JServer
from mmlspark_tpu.utils import config as jconfig
from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.parallel.sharding import mesh_spans_hosts
from mmlspark_tpu_torch.testing.ranks import RankError, RankPool
from mmlspark_tpu_torch.utils import config as tconfig

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
MLP = dict(input_dim=16, hidden=[32, 24], num_classes=5, dtype="float32")
LM = dict(vocab=256, max_len=32)
VIT = dict(num_classes=5, image_size=8, patch=4, dtype="float32")


@pytest.fixture(autouse=True)
def on_cpu():
    tconfig.set("runtime.device", "cpu")
    yield
    tconfig.unset("runtime.device")


@pytest.fixture(scope="module")
def pools():
    made = {}

    def get(world):
        if world not in made:
            made[world] = RankPool(world, paths=[TESTS, REPO])
        return made[world]
    yield get
    for pool in made.values():
        pool.close()


def _params(arch, **kw):
    """One JAX init both packages score (numpy leaves)."""
    return jax.tree_util.tree_map(
        np.asarray, JaxModel().set_model(arch, seed=0, **kw)._state["params"])


def _jax_scores(arch, params, kw, x, col="x", **stage):
    jm = JaxModel(inputCol=col, outputCol="o", **stage)
    jm.set_model(arch, params=params, **kw)
    frame = JFrame.from_dict({col: x}, num_partitions=3 if len(x) >= 3
                             else 1)
    return np.asarray(jm.transform(frame).column("o"))


def _run(pools, world, fn, *args):
    """``fn`` led on rank 0 of a pool of ``world``: rank 0's result (the
    followers' results are their command counts)."""
    out = pools(world).run(f"torch_serve_ranks:{fn}", *args)
    assert all(r["follower_commands"] > 0 for r in out[1:])
    return out[0]


def _no_placements(res):
    assert res["left"] == [[]] * len(res["left"]), res["left"]


# -- test_models.py: meshed TorchModel scoring --------------------------------

SHARDED = [({"data": 2, "tensor": 2}, ""), ({"data": 2, "fsdp": 2}, ""),
           ({"data": -1}, ""), ({"data": 2, "tensor": 2}, "pool"),
           ({"data": 1, "tensor": 2}, ""),
           ({"data": 2, "tensor": 2}, "mlp_fc0/out"),
           ({"data": -1}, "out")]


@pytest.mark.parametrize("spec,node", SHARDED,
                         ids=["data2xtensor2", "data2xfsdp2", "data-1",
                              "pool-data2xtensor2", "submesh-tensor2",
                              "captured-data2xtensor2",
                              "captured-suffix-data-1"])
def test_sharded_scoring_matches_the_reference(pools, spec, node):
    """test_models.py:369 -- params by the standard rules, the batch over
    the data axes, a ragged tail of 70 rows, the ``pool`` node through
    the meshed path, and a mesh of 2 over ranks 0-1 of the 4 (the others
    skip its commands); then every rank's placement is freed. A captured
    node (the reference's capture-all names, a suffix too) scores through
    the meshed path as well."""
    params = _params("mlp_tabular", **MLP)
    x = np.random.default_rng(0).normal(size=(70, 16)).astype(np.float32)
    stage = dict(miniBatchSize=32, outputNodeName=node)
    want = _jax_scores("mlp_tabular", params, MLP, x, **stage)
    res = _run(pools, 4, "score", "mlp_tabular", params, MLP, x, spec,
               stage)
    width = {"": 5, "pool": 24, "out": 5, "mlp_fc0/out": 32}[node]
    assert res["o"].shape == want.shape == (70, width)
    np.testing.assert_allclose(res["o"], want, rtol=1e-5, atol=1e-5)
    _no_placements(res)


LM_NODES = ["block0/attn_query/out", "block1/mlp_down/out",
            "token_embedding/out", "block0/out", "head"]


@pytest.mark.parametrize("spec", [{"data": 1, "tensor": 2},
                                  {"data": 2, "tensor": 2}],
                         ids=["tensor2", "data2xtensor2"])
@pytest.mark.parametrize("node", LM_NODES)
def test_captured_lm_node_on_a_tensor_split_mesh(pools, spec, node):
    """A node of a tensor-split block (a column-split projection gathered
    over ``tensor``, a row-split one summed, the vocabulary-split
    embedding, a block's output, the logits) is captured whole on the
    mesh and equals the JAX package's capture on one device."""
    params = _params("transformer_lm_tiny", **LM)
    ids = np.random.default_rng(6).integers(0, 256, (8, 32)).astype(
        np.int32)
    stage = dict(miniBatchSize=4, outputNodeName=node)
    want = _jax_scores("transformer_lm_tiny", params, LM, ids, col="ids",
                       **stage)
    res = _run(pools, 4, "score", "transformer_lm_tiny", params, LM, ids,
               spec, stage, "ids")
    assert res["o"].shape == want.shape
    np.testing.assert_allclose(res["o"], want, rtol=1e-5, atol=1e-5)
    _no_placements(res)


def test_mesh_spec_persists_as_an_axis_size_dict(pools, tmp_path):
    """test_models.py:411 -- a MeshSpec and a live DeviceMesh both save
    as an axis-size dict, and the loaded stage scores the same."""
    kw = dict(input_dim=8, hidden=[16], num_classes=3, dtype="float32")
    params = _params("mlp_tabular", **kw)
    x = np.random.default_rng(1).normal(size=(16, 8)).astype(np.float32)
    for r in _run(pools, 2, "mesh_spec_round_trip", "mlp_tabular", params,
                  kw, x, str(tmp_path)):
        assert isinstance(r["saved"], dict)
        assert r["saved"]["tensor"] == 2
        np.testing.assert_allclose(r["got"], r["want"], rtol=1e-5,
                                   atol=1e-5)


def test_nonstandard_mesh_axes_are_refused():
    """test_models.py:438 -- an axis the mesh cannot name is refused
    before anything runs."""
    tm = TorchModel(inputCol="x", outputCol="o",
                    meshSpec={"data": 2, "model": 4})
    tm.set_model("mlp_tabular", input_dim=4, hidden=[8], num_classes=2)
    with pytest.raises(ValueError, match="unknown mesh axes"):
        tm.transform(Frame.from_dict({"x": np.zeros((2, 4), np.float32)}))


@pytest.mark.parametrize("spec", [{"data": 1, "seq": 2, "tensor": 2},
                                  {"data": 2, "seq": 2}],
                         ids=["seq2xtensor2", "data2xseq2"])
def test_long_context_sharded_scoring(pools, spec):
    """test_models.py:454 -- a ``seq`` axis routes the LM's attention
    through ring attention and splits the token dim; logits within 1e-3
    of the JAX package's full attention on one device."""
    params = _params("transformer_lm_tiny", **LM)
    ids = np.random.default_rng(0).integers(0, 256, (8, 32),
                                            dtype=np.int32)
    want = _jax_scores("transformer_lm_tiny", params, LM, ids, col="ids",
                       miniBatchSize=4)
    res = _run(pools, 4, "score", "transformer_lm_tiny", params, LM, ids,
               spec, {"miniBatchSize": 4}, "ids")
    np.testing.assert_allclose(res["o"], want, rtol=1e-3, atol=1e-3)


def test_seq_mesh_does_not_inject_attention_into_vit(pools):
    """test_models.py:476 -- the sequence-parallel attention is opt-in
    by spec flag: a ViT on a seq mesh scores through its own attention."""
    params = _params("vit_tiny", **VIT)
    x = np.random.default_rng(2).normal(0, 1, (8, 8 * 8 * 3)).astype(
        np.float32)
    want = _jax_scores("vit_tiny", params, VIT, x, col="img",
                       miniBatchSize=4)
    res = _run(pools, 4, "score", "vit_tiny", params, VIT, x,
               {"data": 1, "seq": 2, "tensor": 2}, {"miniBatchSize": 4},
               "img")
    np.testing.assert_allclose(res["o"], want, rtol=1e-4, atol=1e-4)


def test_sharded_scoring_empty_frame(pools):
    """test_models.py:495 -- 0 rows through the mesh path give an empty
    vector column."""
    kw = dict(input_dim=8, hidden=[8], num_classes=2)
    res = _run(pools, 2, "score", "mlp_tabular", _params("mlp_tabular",
                                                         **kw), kw,
               np.zeros((0, 8), np.float32), {"data": -1},
               {"miniBatchSize": 4})
    assert res["count"] == 0 and res["vector"].endswith("VECTOR")


def test_seq_mesh_non_token_models_keep_feature_dim_unsharded(pools):
    """test_models.py:508 -- an MLP whose width (7) does not divide |seq|
    scores on a seq mesh: its feature dim is never split."""
    kw = dict(input_dim=7, hidden=[8], num_classes=2, dtype="float32")
    params = _params("mlp_tabular", **kw)
    x = np.random.default_rng(3).normal(size=(8, 7)).astype(np.float32)
    want = _jax_scores("mlp_tabular", params, kw, x, miniBatchSize=4)
    res = _run(pools, 4, "score", "mlp_tabular", params, kw, x,
               {"data": 1, "seq": 2, "tensor": 2}, {"miniBatchSize": 4})
    np.testing.assert_allclose(res["o"], want, rtol=1e-5, atol=1e-5)


def test_long_context_feature_extraction_on_seq_mesh(pools):
    """test_models.py:526 -- ``hidden`` through the seq-parallel path."""
    params = _params("transformer_lm_tiny", **LM)
    ids = np.random.default_rng(4).integers(0, 256, (8, 32)).astype(
        np.int32)
    stage = dict(miniBatchSize=4, outputNodeName="hidden")
    want = _jax_scores("transformer_lm_tiny", params, LM, ids, col="ids",
                       **stage)
    res = _run(pools, 4, "score", "transformer_lm_tiny", params, LM, ids,
               {"data": 2, "seq": 2}, stage, "ids")
    np.testing.assert_allclose(res["o"], want, rtol=1e-3, atol=1e-3)


def test_image_featurizer_sharded_scoring_matches(pools):
    """test_image.py:556 -- meshSpec goes to the inner model; the fused
    uint8 wire and the device resize run on each data rank."""
    from mmlspark_tpu.core.schema import ColumnSchema as JColumnSchema
    from mmlspark_tpu.core.schema import DType as JDType
    from mmlspark_tpu.core.schema import ImageValue as JImageValue
    from mmlspark_tpu.image.featurizer import ImageFeaturizer as JFeaturizer
    params = _params("vit_tiny", **VIT)
    images = list(np.random.default_rng(5).integers(0, 256, (6, 20, 30, 3),
                                                    dtype=np.uint8))
    vals = np.empty(len(images), dtype=object)
    for i, im in enumerate(images):
        vals[i] = JImageValue(path=f"mem://{i}", data=im)
    jframe = JFrame.from_dict({"row": np.arange(6)}, num_partitions=2) \
        .with_column_values(JColumnSchema("image", JDType.IMAGE), vals)
    jf = JFeaturizer(cutOutputLayers=1, miniBatchSize=4)
    jf.set_model("vit_tiny", params=params, **VIT)
    want = np.asarray(jf.transform(jframe).column("features"))
    res = _run(pools, 4, "featurize", params, VIT, images,
               {"data": 2, "tensor": 2})
    np.testing.assert_allclose(res["features"], want, rtol=1e-4, atol=1e-4)
    assert res["dp"] == {"srcShape": [20, 30, 3], "resize": [8, 8]}


# -- test_mesh2d.py: decode on a mesh, per-shard bytes ------------------------

GEN = {"generate.max_seq_len": 64, "generate.max_sequences": 4,
       "generate.kv_block_tokens": 8, "generate.shard_kv": True}


def test_decode_on_a_mesh_is_token_equal_and_head_sharded(pools):
    """test_mesh2d.py:158 -- greedy decode at data 2 x tensor 2 equals
    the JAX lane's tokens; the arena's heads split over ``tensor`` (its
    per-rank bytes half the whole), the entry charges per-rank bytes,
    every program a MeshProgram, a rebuilt lane decodes the same, and
    closing the server frees every rank's placement."""
    prompt, n = [5, 9, 17, 3, 250], 6
    params = _params("transformer_lm_tiny")
    prior = {k: jconfig.get(k) for k in GEN}
    for k, v in GEN.items():
        jconfig.set(k, v)
    try:
        srv = JServer({"lm": JaxModel().set_model(
            "transformer_lm_tiny", params=params)}, start=False)
        try:
            lane = srv.enable_generate("lm", start=False)
            f = srv.submit_generate("lm", prompt, max_new_tokens=n)
            for _ in range(96):
                if f.done():
                    break
                lane.step()
            want = f.result(1)["tokens"]
            full = lane.gen.kv.arena_bytes()
        finally:
            srv.close()
    finally:
        for k, v in prior.items():
            jconfig.set(k, v)
    res = _run(pools, 4, "decode", params, {}, prompt, n,
               {"data": 2, "tensor": 2}, GEN)
    assert res["tokens"] == want == res["tokens_again"]
    assert res["mesh"]["tensor"] == 2
    assert "tensor" in tuple(res["arena_spec"])
    assert res["arena_bytes"] == full
    assert res["arena_shard_bytes"] == full // 2
    assert res["resident"] < res["whole_params"] + full
    assert res["kinds"] == ["MeshProgram"]
    # each rank's launches under the prefill program (none on the CPU)
    assert res["prefill_rank_launches"] == [{}] * 4
    _no_placements(res)


def test_decode_on_a_mesh_with_a_whole_arena(pools):
    """``generate.shard_kv`` off: every rank holds all heads of the
    arena (each row gathered over ``tensor`` before it is stored) and
    the tokens still equal the JAX lane's meshed twin's."""
    prompt, n = [5, 9, 17, 3, 250], 6
    params = _params("transformer_lm_tiny")
    sharded = _run(pools, 2, "decode", params, {}, prompt, n,
                   {"data": 1, "tensor": 2}, GEN)
    whole = _run(pools, 2, "decode", params, {}, prompt, n,
                 {"data": 1, "tensor": 2}, {**GEN,
                                             "generate.shard_kv": False})
    assert whole["tokens"] == sharded["tokens"]
    assert whole["arena_spec"] == ()
    assert whole["arena_shard_bytes"] == whole["arena_bytes"] \
        == 2 * sharded["arena_shard_bytes"]


# -- test_embed.py: the recommender served on a mesh --------------------------

DENSE, SLOTS, DIM = 4, 2, 8
TABLES = (("user", 64), ("item", 128))
REC = dict(dense_dim=DENSE, tables=[list(t) for t in TABLES],
           embed_dim=DIM, slots=SLOTS, bottom=[16], top=[16])


def _rec_rows(seed, n=8):
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(n, DENSE)).astype(np.float32)
    uid = rng.integers(1, TABLES[0][1], size=(n, SLOTS))
    iid = rng.integers(1, TABLES[1][1], size=(n, SLOTS))
    return np.concatenate([dense, uid.astype(np.float32),
                           iid.astype(np.float32)], axis=1)


def test_recommender_serving_sharded_bit_identical(pools):
    """test_embed.py:349 -- the tables land row-sharded from the host
    (each rank's bytes half a table), the ledger charges them as
    ``table`` per shard, and the meshed server's scores equal the
    one-device server's bit for bit (and the JAX package's within
    1e-5). The reference's warm-restart test is restated as the port's
    compile-cache decision: each server reports its captures and
    time-to-ready, and ``kernels/_build`` does not change."""
    params = _params("recommender_dlrm", **REC)
    x = _rec_rows(11)
    build = os.path.join(REPO, "mmlspark_tpu_torch", "kernels", "_build")
    before = sorted(os.listdir(build)) if os.path.isdir(build) else None
    one = _run(pools, 4, "serve_rows", "recommender_dlrm", params, REC, x,
               None, 8)
    mesh = _run(pools, 4, "serve_rows", "recommender_dlrm", params, REC, x,
                "data=2,tensor=2", 8)
    again = _run(pools, 4, "serve_rows", "recommender_dlrm", params, REC,
                 x, "data=2,tensor=2", 8)
    assert np.array_equal(mesh["out"], one["out"])
    assert np.array_equal(again["out"], mesh["out"])
    jsrv = JServer({"rec": JaxModel().set_model(
        "recommender_dlrm", params=params, **REC)}, max_batch=8,
        max_wait_ms=1.0)
    try:
        want = jsrv.submit_many("rec", x, timeout=60)
    finally:
        jsrv.close()
    np.testing.assert_allclose(mesh["out"], want, rtol=1e-5, atol=1e-6)
    for name, (local, whole, spec) in mesh["tables"].items():
        assert spec[0] == "tensor", name
        assert local == whole // 2, name
    assert mesh["table"] == sum(t[0] for t in mesh["tables"].values())
    assert mesh["table"] == one["table"] // 2
    assert mesh["params"] > 0
    assert mesh["resident"] == mesh["params"] + mesh["table"]
    assert mesh["projected"] < one["projected"]
    assert mesh["after_close"] == 0
    assert mesh["captures"] == again["captures"] > 0
    assert again["ready_s"] > 0
    after = sorted(os.listdir(build)) if os.path.isdir(build) else None
    assert after == before
    _no_placements(mesh)


def test_audit_attributes_sharded_tables_per_shard(pools):
    """test_embed.py:421 -- a table row-sharded over ``tensor`` is
    charged at its per-shard bytes on every rank, so the audit's
    accounted bytes are half the logical table (the allocator side is
    only measured on a card)."""
    for r in _run(pools, 4, "audit_tables", 512, 16):
        assert r["accounted"] == r["logical"] // 2
        assert r["supported"] is False


# -- test_fleet.py and test_autopilot.py: Fleet.reshard -----------------------

FLEET_KW = dict(input_dim=8, hidden=[16], num_classes=3)


def _fleet_x():
    return np.random.default_rng(6).normal(size=(1, 8)).astype(np.float32)


def test_fleet_reshard_bit_identical_zero_downtime(pools):
    """test_fleet.py:540 at 2x2 -- a live reshard under closed-loop fire:
    no failed request, every answer bit-equal to the unresharded one,
    both replicas resharded onto ONE shared placement, a scale_up on the
    new placement, then back to one device."""
    params = _params("mlp_tabular", **FLEET_KW)
    x = _fleet_x()
    want = _jax_scores("mlp_tabular", params, FLEET_KW, x)
    res = _run(pools, 4, "fleet_reshard", params, FLEET_KW, x, "2x2", 2)
    assert res["errors"] == [] and res["fired"]
    for got in res["fired"] + res["after"] + [res["scaled_answer"],
                                              res["back"]["answer"]]:
        assert np.array_equal(got, res["before"])
    np.testing.assert_allclose(res["before"], want, rtol=1e-5, atol=1e-6)
    assert [r["status"] for r in res["report"]["replicas"]] == \
        ["resharded", "resharded"]
    assert res["report"]["mesh_shape"] == "2x2" == res["mesh_shape"]
    assert res["spec"] == (2, 2) and res["tensor"] == 2
    assert res["placements_in_use"] == 1
    assert res["scaled"][1:] == (2, 2)
    assert res["placements_after_scale"] == 1
    assert res["back"]["mesh_shape"] == "" == res["back"]["fleet"]
    assert res["back"]["spec"] is None
    _no_placements(res)


def test_fleet_reshard_over_budget_degrades_to_noop(pools):
    """test_fleet.py:589 -- over the registry budget the reshard raises
    before any entry is dropped: every replica serves as before."""
    params = _params("mlp_tabular", **FLEET_KW)
    x = _fleet_x()
    res = _run(pools, 4, "fleet_over_budget", params, FLEET_KW, x, "2x2")
    assert res["raised"] and "budget" in res["raised"]
    assert res["mesh_shape"] == "" and res["weight"] == 1.0
    assert res["spec"] is None
    assert np.array_equal(res["got"], res["want"])
    _no_placements(res)


def test_fleet_reshard_skips_dead_and_records_them(pools):
    """test_fleet.py:615 -- a replica dead before the reshard is
    ``skipped_dead``; the survivors reshard and answer the same."""
    params = _params("mlp_tabular", **FLEET_KW)
    x = _fleet_x()
    res = _run(pools, 4, "fleet_reshard", params, FLEET_KW, x, "2x2", 3, 1)
    assert [r["status"] for r in res["report"]["replicas"]] == \
        ["resharded", "skipped_dead", "resharded"]
    assert res["report"]["resharded"] == 2
    assert res["errors"] == []
    for got in res["after"]:
        assert np.array_equal(got, res["before"])


def test_fleet_reshard_back_to_single_device(pools):
    """test_fleet.py:629 -- tensor 2 on two ranks and ``reshard(None)``
    back to the one-device path, answers bit-equal throughout."""
    params = _params("mlp_tabular", **FLEET_KW)
    x = _fleet_x()
    res = _run(pools, 2, "fleet_reshard", params, FLEET_KW, x, "1x2", 2)
    assert res["report"]["mesh_shape"] == "1x2" and res["tensor"] == 2
    assert res["back"]["mesh_shape"] == "" and res["back"]["spec"] is None
    assert np.array_equal(res["back"]["answer"], res["before"])
    _no_placements(res)


def test_autopilot_actuates_reshard_on_live_fleet(pools):
    """test_autopilot.py:692 -- HBM pressure and a ``reshard_wide``
    policy actuate ``Fleet.reshard`` through ``_actuate``; the fleet's
    mesh_shape feeds back and the next tick vetoes at the target."""
    params = _params("mlp_tabular", **FLEET_KW)
    x = _fleet_x()
    res = _run(pools, 2, "autopilot_reshard", params, FLEET_KW, x, "1x2")
    assert res["actions"] == ["reshard_wide"]
    assert res["errors"] == [None] and res["resharded"] == [1]
    assert res["mesh_shape"] == "1x2" and res["spec"] == (1, 2)
    assert res["again"] and all(s for s, _ in res["again"])
    assert res["again"][0][1].startswith("bounds:at_target")
    assert np.array_equal(res["got"], res["want"])


# -- the execution model's refusals and failures ------------------------------

def test_scoring_mesh_is_per_host():
    """The predicate behind the per-host rule: ranks on one host pass,
    a mesh reaching another host is refused (the trainer's
    ``mesh_spans_processes`` keeps its meaning)."""
    hosts = ["a", "a", "b", "b"]
    assert not mesh_spans_hosts(hosts, range(2))
    assert mesh_spans_hosts(hosts, range(3))
    assert mesh_spans_hosts(hosts, range(4))
    assert not mesh_spans_hosts(["a"], range(1))


def test_a_mesh_across_hosts_or_beyond_the_world_is_refused():
    """A follower on another host: rank 0's meshed scoring raises
    ``SchemaError`` with the reference's per-host message; a mesh larger
    than the world raises too."""
    kw = dict(input_dim=4, hidden=[8], num_classes=2)
    params = _params("mlp_tabular", **kw)
    with RankPool(2, paths=[TESTS, REPO]) as pool:
        res = pool.run("torch_serve_ranks:elsewhere", "mlp_tabular", params,
                       kw, np.zeros((4, 4), np.float32))[0]
    assert res["hosts"][1] == "another-host"
    assert "scoring is per-host" in res["refused"]
    assert "mesh of this host's ranks" in res["refused"]
    assert "world of 2" in res["too_big"]


def test_a_follower_death_fails_the_call_retryably(tmp_path):
    """A follower that dies inside a command fails the leader's call with
    a retryable ConnectionError within the channel's timeout, the next
    call fails at once (never scored by the leader alone), and the pool
    replaces its ranks."""
    kw = dict(input_dim=4, hidden=[8], num_classes=2)
    params = _params("mlp_tabular", **kw)
    path = str(tmp_path / "seen.json")
    pool = RankPool(2, paths=[TESTS, REPO], timeout_s=60.0,
                    env={"MMLSPARK_TPU_TORCH_RUNTIME_MESH_TIMEOUT_S": "20"})
    try:
        with pytest.raises(RankError, match="died"):
            pool.run("torch_serve_ranks:follower_dies", "mlp_tabular",
                     params, kw, np.ones((4, 4), np.float32), path)
        deadline = 60
        while not os.path.exists(path) and deadline:
            import time
            time.sleep(1)
            deadline -= 1
        with open(path) as f:
            seen = json.load(f)
        assert len(seen["first"]) == 4
        assert seen["died"]["connection"] and seen["died"]["retryable"]
        assert seen["died"]["seconds"] < 30
        assert seen["next"]["connection"]
        # the replaced ranks lead and follow again
        assert pool.run("torch_serve_ranks:nothing")[0] == {"world": 2}
    finally:
        pool.close()
