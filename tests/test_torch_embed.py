"""Row-sharded embedding tables and the DLRM in the port, on the CPU.

The port's ranks are gloo processes of one module-scoped pool of 4
(functions in ``tests/torch_parallel_ranks.py``, no JAX there). The JAX
side runs here (its reference functions on one device, its trainer on the
first 4 of conftest's 8 virtual CPU devices), on the same numpy inputs.

Tolerances: the fused lookup and the sparse gradient are BIT-equal to the
port's unsharded references (the same rows, the same sums in the same
order), and within 1 ulp of the JAX package's references (torch and XLA
multiply a row by its weight and add the bags alike; 1 ulp is the slack
for a fused multiply-add). The DLRM's 2-D (data x tensor, fused) losses
are held at atol 2e-6 against the port's 1-D run (the dense towers' sums
split otherwise), its 1-D losses at rtol 5e-5 against the JAX 1-D trainer
(adam's fp32 bias correction in optax; the reference's own 2-D against
1-D test fails in the reference and is no oracle here).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmlspark_tpu.embed.model import pack_rows as jpack_rows
from mmlspark_tpu.embed.tables import (
    _reference_table_grad as jreference_grad,
    bag_lookup_reference as jbag_lookup_reference,
)
from mmlspark_tpu.models.zoo import build_model as jbuild
from mmlspark_tpu.parallel.mesh import MeshSpec as JMeshSpec
from mmlspark_tpu.parallel.mesh import make_mesh as jmake_mesh
from mmlspark_tpu.parallel.sharding import (
    embedding_lookup_specs as jlookup_specs,
    embedding_table_sharding as jtable_sharding,
)
from mmlspark_tpu.parallel.trainer import (
    DistributedTrainer as JaxDistributedTrainer,
)
from mmlspark_tpu_torch.embed.model import DLRM, pack_rows, padded_rows
from mmlspark_tpu_torch.embed.tables import (
    PAD_ID, EmbeddingCollection, EmbeddingTable, RowResidency,
    _reference_table_grad, bag_lookup_reference, make_fused_lookup,
    make_sparse_grad,
)
from mmlspark_tpu_torch.models.convert import from_jax_params
from mmlspark_tpu_torch.models.zoo import build_model, init_state
from mmlspark_tpu_torch.observability import memory as tmemory
from mmlspark_tpu_torch.parallel.sharding import (
    embedding_lookup_specs, embedding_table_sharding,
)
from mmlspark_tpu_torch.testing.ranks import RankPool
from mmlspark_tpu_torch.utils import config as tconfig

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
ROWS, DIM, B, SLOTS = 64, 8, 8, 4
MESH22 = {"data": 2, "tensor": 2}


@pytest.fixture(autouse=True)
def on_cpu():
    tconfig.set("runtime.device", "cpu")
    yield
    tconfig.unset("runtime.device")


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, paths=[TESTS, REPO]) as p:
        yield p


def _table(rng, rows=ROWS):
    t = rng.normal(size=(rows, DIM)).astype(np.float32)
    t[PAD_ID] = 0.0
    return t


def _batch(rng, rows=ROWS):
    ids = rng.integers(1, rows, size=(B, SLOTS)).astype(np.int32)
    return ids, (ids != PAD_ID).astype(np.float32)


def _unique_ids(rows=ROWS):
    ids = np.arange(1, 1 + B * SLOTS, dtype=np.int32).reshape(B, SLOTS)
    return ids, np.ones((B, SLOTS), np.float32)


def _ref(table, ids, w):
    return bag_lookup_reference(torch.from_numpy(table),
                                torch.from_numpy(ids),
                                torch.from_numpy(w)).numpy()


def _jref(table, ids, w):
    return np.asarray(jbag_lookup_reference(jnp.asarray(table),
                                            jnp.asarray(ids),
                                            jnp.asarray(w)))


# -- the fused lookup ----------------------------------------------------------

def test_fused_lookup_bit_identical_to_reference(pool):
    """data 2 x tensor 2: bucketize, all-to-all, local gather, all-to-all
    back, the bags: BIT-equal to the port's reference, within 1 ulp of
    the JAX reference."""
    rng = np.random.default_rng(0)
    table, (ids, w) = _table(rng), _batch(rng)
    want = _ref(table, ids, w)
    np.testing.assert_array_max_ulp(want, _jref(table, ids, w), maxulp=1)
    for got in pool.run("torch_parallel_ranks:embed_lookup", MESH22, table,
                        ids, w):
        assert np.array_equal(got, want)


def test_fused_lookup_masks_pad_slots(pool):
    rng = np.random.default_rng(1)
    table = _table(rng)
    ids, w = _batch(rng)
    ids[:, -1] = PAD_ID           # every bag carries one pad slot
    w = (ids != PAD_ID).astype(np.float32)
    want = _ref(table, ids, w)
    for got in pool.run("torch_parallel_ranks:embed_lookup",
                        {"data": 1, "tensor": 4}, table, ids, w):
        assert np.array_equal(got, want)
    # the pad contributes exactly nothing (row 0 is zero AND its weight)
    ids2 = ids.copy()
    ids2[:, -1] = 3
    assert not np.array_equal(want, _ref(table, ids2,
                                         (ids2 != PAD_ID).astype(np.float32)))


def test_fused_lookup_unsharded_mesh_falls_back(pool):
    """No mesh, a mesh without ``tensor``, or ``embed.fused_lookup`` off:
    the reference path, on the whole table."""
    assert make_fused_lookup(None) is bag_lookup_reference
    rng = np.random.default_rng(6)
    table, (ids, w) = _table(rng), _batch(rng)
    want = _ref(table, ids, w)
    for got in pool.run("torch_parallel_ranks:embed_lookup", {"data": 4},
                        table, ids, w, False):
        assert np.array_equal(got, want)


def test_table_and_lookup_specs_equal_the_reference():
    for axes in (dict(data=4, tensor=2), dict(data=8), dict(data=2,
                                                            fsdp=2,
                                                            tensor=2)):
        jm = jmake_mesh(JMeshSpec(**axes))
        sizes = JMeshSpec(**axes).resolve(8)

        def norm(spec):
            return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                         for e in spec)
        assert norm(embedding_table_sharding(sizes)) == norm(
            tuple(jtable_sharding(jm).spec))
        for got, want in zip(embedding_lookup_specs(sizes),
                             jlookup_specs(jm)):
            assert norm(got) == norm(tuple(want))


# -- the sparse gradient -------------------------------------------------------

@pytest.mark.parametrize("unique", [True, False], ids=["unique", "repeated"])
def test_sparse_grad_bit_identical_to_reference(pool, unique):
    """All-gather (ids, weights, cotangents) over data, scatter-add into
    the owned rows in global batch order: BIT-equal to the port's
    unsharded scatter (repeated ids too: the same order), within 1 ulp of
    the JAX reference; the only collective is the O(batch) all-gather."""
    rng = np.random.default_rng(2)
    table = _table(rng)
    ids, w = _unique_ids() if unique else _batch(rng)
    gbags = rng.normal(size=(B, DIM)).astype(np.float32)
    want = _reference_table_grad(ROWS, torch.from_numpy(ids),
                                 torch.from_numpy(w),
                                 torch.from_numpy(gbags)).numpy()
    np.testing.assert_array_max_ulp(
        want, np.asarray(jreference_grad(ROWS, jnp.asarray(ids),
                                         jnp.asarray(w), jnp.asarray(gbags))),
        maxulp=1)
    for r in pool.run("torch_parallel_ranks:embed_grad", MESH22, table, ids,
                      w, gbags):
        assert np.array_equal(r["grad"], want)
        assert set(r["traffic"]) == {"all_gather"}
        assert r["traffic"]["all_gather"]["bytes"] == \
            (ids.nbytes + w.nbytes + gbags.nbytes) // 2


def test_bag_lookup_gradient_matches_dense_autodiff(pool):
    """``make_bag_lookup``'s backward (the sparse gradient, the ids and
    weights zero) equals dense autodiff through the unsharded reference
    on one device, bit for bit."""
    rng = np.random.default_rng(3)
    table = _table(rng)
    ids, w = _unique_ids()
    target = rng.normal(size=(B, DIM)).astype(np.float32)
    t = torch.from_numpy(table).requires_grad_()
    ((bag_lookup_reference(t, torch.from_numpy(ids), torch.from_numpy(w))
      - torch.from_numpy(target)) ** 2).sum().backward()
    for got in pool.run("torch_parallel_ranks:embed_autograd", MESH22,
                        table, ids, w, target):
        assert np.array_equal(got, t.grad.numpy())


# -- the collection ------------------------------------------------------------

def test_collection_update_matches_unsharded_and_stays_resident(pool):
    """One host init, placed on data 2 x tensor 2 and on one device: the
    bags and the tables after one sparse sgd update are bit-equal; each
    rank holds half the (padded) table bytes."""
    specs = [("user", 60, DIM), ("item", 120, DIM)]
    rng = np.random.default_rng(4)
    batch, off = {}, 1
    for name, rows, _ in specs:
        ids = (off + np.arange(B * SLOTS, dtype=np.int32)).reshape(B, SLOTS)
        assert ids.max() < rows
        batch[name] = (ids, np.ones((B, SLOTS), np.float32))
    gbags = {name: rng.normal(size=(B, DIM)).astype(np.float32)
             for name, _, _ in specs}
    ranks = pool.run("torch_parallel_ranks:collection_round", MESH22, specs,
                     7, batch, gbags, 0.5)
    import torch_parallel_ranks as P
    local = P.collection_round(0, 1, None, specs, 7, batch, gbags, 0.5)
    for r in ranks:
        for name in local["tables"]:
            assert np.array_equal(r["tables"][name], local["tables"][name])
            assert np.array_equal(r["bags"][name], local["bags"][name])
        assert r["logical"] == local["logical"]
        assert r["resident"] * 2 == r["logical"]


def test_collection_rejects_duplicate_names():
    with pytest.raises(ValueError):
        EmbeddingCollection([EmbeddingTable("a", 8, 4),
                             EmbeddingTable("a", 8, 4)])


def test_collection_init_pads_and_is_repeatable():
    """Tables pad to the tensor multiple; the init is the same in every
    process (seeded by the name's crc32, not Python's salted ``hash``)."""
    spec = EmbeddingTable("user", 61, DIM)
    assert spec.padded_rows({"data": 1, "tensor": 2}) == 62
    assert spec.padded_rows(None) == 61
    assert spec.logical_bytes() == 61 * DIM * 4
    coll = EmbeddingCollection([spec], device="cpu")
    a, b = coll.init(3), coll.init(3)
    assert a["user"].shape == (61, DIM)
    assert np.array_equal(a["user"], b["user"])
    assert not a["user"][PAD_ID].any()
    assert np.array_equal(EmbeddingCollection([spec], device="cpu").init(3)
                          ["user"], a["user"])


# -- the DLRM through the trainer ----------------------------------------------

TABLES = (("user", 60), ("item", 120))
DENSE = 6
KW = dict(dense_dim=DENSE, tables=TABLES, embed_dim=DIM, slots=SLOTS,
          bottom=(16,), top=(16,))


def _jax_dlrm():
    return jbuild("recommender_dlrm", **KW)["module"]


@pytest.fixture(scope="module")
def dlrm_init():
    width = DENSE + len(TABLES) * SLOTS
    params = _jax_dlrm().init(jax.random.PRNGKey(0),
                              jnp.zeros((1, width), jnp.float32))
    params = jax.tree_util.tree_map(np.asarray, params)
    return params, from_jax_params(params)


def _dlrm_batches(steps=3):
    out = []
    for i in range(steps):
        rng = np.random.default_rng(100 + i)
        dense = rng.normal(size=(B, DENSE)).astype(np.float32)
        uid = rng.integers(1, padded_rows(TABLES[0][1]), size=(B, SLOTS))
        iid = rng.integers(1, padded_rows(TABLES[1][1]), size=(B, SLOTS))
        y = (rng.random(B) > 0.5).astype(np.float32)
        out.append({"x": pack_rows(dense, [uid, iid]), "y": y})
    return out


def _jax_dlrm_losses(jparams, batches):
    module = _jax_dlrm()
    mesh = jmake_mesh(JMeshSpec(data=4), jax.devices()[:4])

    def loss_fn(params, batch, rng):
        logits = module.apply(params, batch["x"])
        return optax.sigmoid_binary_cross_entropy(
            logits[:, 0], batch["y"]).mean()
    opt = optax.adam(1e-2)
    trainer = JaxDistributedTrainer(loss_fn, opt, mesh=mesh)
    _, shardings = trainer.abstract_state(lambda: jparams)
    state = jax.device_put({"params": jparams, "opt_state": opt.init(jparams),
                            "step": jnp.zeros((), jnp.int32)}, shardings)
    losses = []
    for b in batches:
        state, m = trainer.train_step(state, trainer.put_batch(b),
                                      jax.random.PRNGKey(0))
        losses.append(float(jax.device_get(m["loss"])))
    return losses


def test_dlrm_fused_2d_losses_match_1d(pool, dlrm_init):
    """The port's DLRM at data 2 x tensor 2 (fused lookup, sparse
    gradient, tables row-split and claimed, their gradient left out of
    the data all-reduce) against its own run at data 4 (the reference
    lookup, dense table gradients all-reduced): losses within 2e-6 and
    falling on one batch; the 1-D losses against the JAX trainer at data
    4; the only
    all-reduce is the dense towers' gradient sum, never a table's."""
    jparams, tparams = dlrm_init
    batches = _dlrm_batches(1) * 3
    two = pool.run("torch_parallel_ranks:dlrm_train", "2x2", tparams,
                   batches, KW)
    one = pool.run("torch_parallel_ranks:dlrm_train", "4", tparams,
                   batches, KW)
    want = _jax_dlrm_losses(jparams, batches)
    np.testing.assert_allclose(one[0]["losses"], want, rtol=5e-5)
    table_bytes = sum(v.nbytes for k, v in tparams.items()
                      if k.endswith("_embedding"))
    dense_bytes = sum(v.nbytes for k, v in tparams.items()
                      if not k.endswith("_embedding"))
    for r in two:
        np.testing.assert_allclose(r["losses"], one[0]["losses"], rtol=0,
                                   atol=2e-6)
        assert r["specs"]["item_embedding"][0] == "tensor"
        assert r["local_shapes"]["user_embedding"] == (
            padded_rows(60) // 2, DIM)
        assert sorted(r["summed"]) == ["item_embedding", "user_embedding"]
        assert r["shard_bytes"] == r["projected"] == dense_bytes + \
            table_bytes // 2
        # a step all-reduces the dense gradients (one flat buffer) and the
        # loss, never a table's gradient (the 1-D run sums them all)
        assert r["traffic"]["all_reduce"] == {
            "calls": 2 * len(batches),
            "bytes": len(batches) * (dense_bytes + 4)}
    assert one[0]["traffic"]["all_reduce"]["bytes"] == len(batches) * (
        dense_bytes + table_bytes + 4)
    assert two[0]["losses"][-1] < two[0]["losses"][0]
    for name, value in one[0]["params"].items():
        np.testing.assert_allclose(two[0]["params"][name], value, atol=2e-6,
                                   rtol=0, err_msg=name)


def test_dlrm_checkpoint_restores_across_mesh_shapes(pool, dlrm_init,
                                                     tmp_path):
    """Saved at data 2 x tensor 2, restored at tensor 4 (each rank a
    quarter of the rows) and back: every restore equals its save; the
    run continues from it."""
    _, tparams = dlrm_init
    batches = _dlrm_batches(6)
    steps = [batches[:2], batches[2:4], batches[4:]]
    ranks = pool.run("torch_parallel_ranks:checkpoint_shapes", "dlrm",
                     {"params": tparams, "arch": KW}, steps,
                     str(tmp_path / "ck"), ["2x2", "1x4", "2x2"])
    for r in ranks:
        for prev, cur in zip(r, r[1:]):
            for name, value in prev["saved"].items():
                assert np.array_equal(cur["restored"][name], value), name
        assert [c["local_shapes"]["user_embedding"][0] for c in r] == \
            [32, 16, 32]
        assert all(c["specs"]["user_embedding"][0] == "tensor" for c in r)
        assert [c["step"] for c in r] == [2, 4, 6]
        assert all(np.isfinite(c["losses"]).all() for c in r)


def test_dlrm_from_jax_params_scores_like_the_reference(dlrm_init):
    """A flax DLRM's tree through ``from_jax_params`` into the port's:
    the same logits and interaction features on packed rows."""
    jparams, tparams = dlrm_init
    x = _dlrm_batches(1)[0]["x"]
    jmodule = _jax_dlrm()
    want, state = jmodule.apply(jparams, x, mutable=["intermediates"])
    module = build_model("recommender_dlrm", **KW)["module"]
    module.load_state_dict({k: torch.from_numpy(v)
                            for k, v in tparams.items()})
    got, inters = module.forward_with_intermediates(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        inters["interaction"].detach().numpy(),
        np.asarray(state["intermediates"]["interaction"][0]), atol=1e-6,
        rtol=0)
    # init_state draws the tables as the flax initializer does
    drawn = init_state(module, 0)
    for name in ("user_embedding", "item_embedding"):
        assert drawn[name].shape == tparams[name].shape
        assert abs(float(drawn[name].std()) - DIM ** -0.5) < 0.05


def test_zoo_spec_padding_and_packing():
    spec = build_model("recommender_dlrm", dense_dim=4,
                       tables=[["clicks", 33]], embed_dim=4, slots=2)
    assert isinstance(spec["module"], DLRM)
    assert spec["module"].tables == (("clicks", padded_rows(33)),)
    assert spec["input_shape"] == (4 + 2,)
    assert spec["feature_layer"] == "interaction"
    dense = np.ones((2, 4), np.float32)
    ids = np.array([[1, 2], [3, 0]], np.int64)
    x = pack_rows(dense, [ids])
    assert x.dtype == np.float32 and x.shape == (2, 6)
    assert np.array_equal(x[:, 4:].astype(np.int64), ids)
    assert np.array_equal(x, jpack_rows(dense, [ids]))


def test_embed_config_keys_row_multiple_and_fused_lookup(pool):
    """``embed.row_multiple`` pads the tables; ``embed.fused_lookup``
    off drops both directions back to the reference path."""
    assert padded_rows(33) == 40
    tconfig.set("embed.row_multiple", 16)
    try:
        assert padded_rows(33) == 48
    finally:
        tconfig.unset("embed.row_multiple")
    tconfig.set("embed.fused_lookup", False)
    try:
        mesh = {"data": 4, "tensor": 2}
        assert make_fused_lookup(mesh) is bag_lookup_reference
        tab = torch.arange(ROWS * DIM, dtype=torch.float32).reshape(ROWS, DIM)
        ids = torch.arange(B * SLOTS).reshape(B, SLOTS) % ROWS
        w = torch.ones((B, SLOTS))
        g = torch.ones((B, DIM))
        assert torch.equal(make_sparse_grad(mesh)(tab, ids, w, g),
                           _reference_table_grad(ROWS, ids, w, g))
    finally:
        tconfig.unset("embed.fused_lookup")
    rng = np.random.default_rng(8)
    table, (ids, w) = _table(rng), _batch(rng)
    gbags = rng.normal(size=(B, DIM)).astype(np.float32)
    for r in pool.run("torch_parallel_ranks:embed_grad", MESH22, table, ids,
                      w, gbags, False):
        # each rank's block of the batch on the whole table, unsharded
        assert r["grad"].shape == (ROWS, DIM)
        assert "all_gather" not in r["traffic"]


# -- per-row residency: frequency-capped cold-first eviction --------------------

@pytest.fixture
def _ledger():
    led = tmemory.MemoryLedger()
    yield led


def _residency(ledger, rows=32, dim=4, cap=4, freq_cap=3):
    rng = np.random.default_rng(7)
    master = rng.normal(size=(rows, dim)).astype(np.float32)
    return master, RowResidency("pool", master, capacity_rows=cap,
                                freq_cap=freq_cap, ledger=ledger)


def test_row_residency_bit_identical_and_ledger_tracks(_ledger):
    master, pool = _residency(_ledger)
    ids = [1, 5, 1, 9, 5, 2]
    out = pool.lookup(ids)
    assert np.array_equal(out, master[ids])
    row_b = master[0].nbytes
    assert pool.resident_rows == 4
    assert _ledger.total(model="pool", kind="table") == 4 * row_b
    s = pool.stats()
    assert s["misses"] == 4 and s["hits"] == 2 and s["evictions"] == 0


def test_row_residency_evicts_cold_rows_first(_ledger):
    master, pool = _residency(_ledger, cap=3)
    pool.lookup([1, 2, 3])
    pool.lookup([2, 3])
    pool.lookup([4])
    assert pool.evictions == 1
    assert set(pool._slot) == {2, 3, 4}
    assert np.array_equal(pool.lookup([1]), master[[1]])
    assert _ledger.total(model="pool", kind="table") == 3 * master[0].nbytes


def test_row_residency_frequency_cap_bounds_stale_heat(_ledger):
    master, pool = _residency(_ledger, cap=3, freq_cap=3)
    pool.lookup([1] * 50)
    assert pool._freq[1] == 3
    pool.lookup([2, 3])
    for rid in (4, 5, 6):
        pool.lookup([rid] * 3)
    assert 1 not in pool._slot
    assert pool.resident_rows == 3


def test_row_residency_close_reconciles_to_zero(_ledger):
    master, pool = _residency(_ledger)
    pool.lookup([1, 2, 3, 4, 5])
    assert _ledger.total(model="pool", kind="table") > 0
    pool.close()
    assert _ledger.total(model="pool") == 0
    assert _ledger.total(kind="table") == 0
    pool.close()
    with pytest.raises(RuntimeError):
        pool.lookup([1])


def test_row_residency_eviction_order_deterministic():
    from mmlspark_tpu.embed.tables import RowResidency as JRowResidency
    from mmlspark_tpu.observability.memory import MemoryLedger as JLedger
    seqs = []
    for make, ledger in ((RowResidency, tmemory.MemoryLedger),
                         (RowResidency, tmemory.MemoryLedger),
                         (JRowResidency, JLedger)):
        rng = np.random.default_rng(7)
        master = rng.normal(size=(64, 4)).astype(np.float32)
        pool = make("pool", master, capacity_rows=4, freq_cap=3,
                    ledger=ledger())
        rng = np.random.default_rng(11)
        for _step in range(40):
            pool.lookup(rng.integers(1, 64, size=3).tolist())
        seqs.append((pool.evictions, sorted(pool._slot), pool.stats()))
    assert seqs[0] == seqs[1] == seqs[2]     # and the reference's
