"""Multi-process training inputs in the port against the JAX package's, on
the CPU.

The port's ranks are gloo processes of one module-scoped
``mmlspark_tpu_torch.testing.ranks.RankPool`` of two ranks (their
functions are in ``tests/torch_input_ranks.py``, which imports no JAX):
each rank holds its own rows, as the reference's processes did. The JAX
side runs here, in one process, on 2 of conftest's 8 virtual CPU
devices, over the whole frame, or (for ``_allreduce_moments``) in two
threads whose ``process_allgather`` meet at a barrier.
"""
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mmlspark_tpu.core.frame import Frame as JFrame
from mmlspark_tpu.models.zoo import build_model as jbuild
from mmlspark_tpu.parallel.mesh import data_parallel_mesh
from mmlspark_tpu.train import learners as jlearners
from mmlspark_tpu.train.deep import DeepClassifier as JDeepClassifier
from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.models.convert import from_jax_params
from mmlspark_tpu_torch.parallel.trainer import DeviceEpochCache
from mmlspark_tpu_torch.testing.ranks import RankPool
from mmlspark_tpu_torch.train import learners as tl
from mmlspark_tpu_torch.utils import config as tconfig

import torch_input_ranks as R

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
DATA2 = {"data": 2}


@pytest.fixture(autouse=True)
def on_cpu():
    tconfig.set("runtime.device", "cpu")
    yield
    tconfig.unset("runtime.device")


@pytest.fixture(scope="module")
def pool():
    p = RankPool(2, paths=[TESTS, REPO])
    yield p
    p.close()


def _xy(n, d=6, seed=42):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x, (x[:, 0] + x[:, 1] > 0).astype(np.int64)


# -- DeepClassifier ------------------------------------------------------------

@pytest.mark.parametrize("cache", ["on", "off"])
def test_deep_classifier_on_rank_shards_matches_the_jax_package(pool, cache):
    """DeepClassifier at data 2, each rank given its block-cyclic shard of
    64 rows (``process_shard(block_rows=32)``: 32 is its share of the
    global batch of 64), against the JAX package's DeepClassifier on a
    2-device data mesh over the whole frame, from one flax init.

    Every epoch is one global batch, so both sides train on the same rows
    each step and only the order of float sums differs (the ranks' gloo
    all-reduce against XLA's): the final loss at rtol 1e-4, the params at
    atol 1e-4 and every prediction equal. The reference's own
    cross-topology test (rtol 2e-2, >= 62/64 predictions) compares runs
    whose batches differ in composition; here they do not, so the bound
    is tighter."""
    x, y = _xy(64)
    kw = dict(architecture="mlp_tabular", architectureArgs={"hidden": [16]},
              batchSize=64, epochs=8, learningRate=1e-2,
              trainDtype="float32", deviceCache=cache, seed=0)
    jl = JDeepClassifier(meshSpec=data_parallel_mesh(jax.devices()[:2]), **kw)
    jl.set_params(featuresCol="features", labelCol="label")
    jframe = JFrame.from_dict({"features": x, "label": y})
    jmodel = jl.fit(jframe)
    spec = jbuild("mlp_tabular", input_dim=6, hidden=[16], num_classes=2,
                  dtype="float32")
    init = spec["module"].init(jax.random.PRNGKey(0), jnp.zeros((1, 6)))
    init = from_jax_params(jax.tree_util.tree_map(np.asarray, init))
    ranks = pool.run("torch_input_ranks:deep_shard_fit", DATA2, x, y, kw,
                     32, init)
    want_params = from_jax_params(jmodel._state["params"])
    want_pred = np.asarray(jmodel.transform(jframe).column("prediction"))
    for r in ranks:
        np.testing.assert_allclose(r["final_loss"],
                                   float(jmodel._state["final_loss"]),
                                   rtol=1e-4)
        for name, value in want_params.items():
            np.testing.assert_allclose(r["params"][name], value, atol=1e-4,
                                       rtol=0, err_msg=name)
        np.testing.assert_array_equal(r["prediction"], want_pred)
    np.testing.assert_array_equal(ranks[0]["probability"],
                                  ranks[1]["probability"])


# -- _allreduce_moments ----------------------------------------------------------

def _jax_allreduce(shards):
    """The JAX package's ``_allreduce_moments`` run as two processes would:
    one thread a process, each with its shard's moments, their
    ``process_allgather`` calls meeting at a barrier. A raise comes back
    as its message; a thread left waiting by the other's raise as
    "waiting"."""
    from jax.experimental import multihost_utils
    n = len(shards)
    barrier = threading.Barrier(n, timeout=2)
    local = threading.local()
    store, out = {}, [None] * n

    def gather(x):
        k = local.calls
        local.calls += 1
        store[(k, local.rank)] = np.asarray(x)
        barrier.wait()
        got = np.stack([store[(k, i)] for i in range(n)])
        barrier.wait()
        return got

    def run(rank):
        local.rank, local.calls = rank, 0
        x, y = shards[rank]
        est = JDeepClassifier(featuresCol="features", labelCol="label")
        moments = est._streaming_moments(
            JFrame.from_dict({"features": x, "label": y}))
        try:
            out[rank] = {"moments": est._allreduce_moments(moments)}
        except ValueError as e:
            out[rank] = {"error": str(e)}
        except threading.BrokenBarrierError:
            out[rank] = {"error": "waiting"}
    saved = multihost_utils.process_allgather
    multihost_utils.process_allgather = gather
    try:
        threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    finally:
        multihost_utils.process_allgather = saved
    return out


def _shards(kind):
    x, y = _xy(40)
    y = y * 2 + (x[:, 2] > 0)               # labels 0..3
    if kind == "even":
        return [(x[:20], y[:20]), (x[20:], y[20:])]
    if kind == "uneven":
        return [(x[:33], y[:33]), (x[33:], y[33:])]
    if kind == "empty":
        return [(x, y), (x[:0], y[:0])]
    return [(x, y), (x[:, :4].copy(), y)]   # "width": 6 against 4


@pytest.mark.parametrize("kind", ["even", "uneven", "empty", "width"])
def test_allreduce_moments_matches_the_reference(pool, kind):
    """The moments of each rank's shard summed over the data ranks, against
    the reference's function on the same shards: even, uneven, one empty
    shard (it contributes zeros once the widths are agreed), and differing
    widths, which raise: on every rank in the port, on the narrower
    process in the reference (the wider one is left waiting)."""
    shards = _shards(kind)
    got = pool.run("torch_input_ranks:allreduce_moments", DATA2, shards)
    want = _jax_allreduce(shards)
    if kind == "width":
        assert all("feature width differs" in g["error"] for g in got)
        assert "feature width differs" in want[1]["error"]
        return
    for g in got:
        for a, b in zip(g["moments"], want[0]["moments"]):
            if isinstance(b, np.ndarray):
                np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-9)
            else:
                assert a == pytest.approx(b, rel=1e-12)


# -- the local-rows epoch cache ----------------------------------------------

@pytest.mark.parametrize("shuffle", [True, False])
def test_local_rows_epoch_cache_is_bit_equal_to_one_rank(pool, shuffle):
    """Each rank builds the cache from ITS rows only (its block-cyclic
    share of a 48-row epoch, batch 8): over 3 epochs each rank's batches
    are, bit for bit, its block of the one-rank cache's batches over the
    whole epoch in the reference's block-cyclic order."""
    rng = np.random.default_rng(3)
    data = {"x": rng.normal(size=(48, 5)).astype(np.float32),
            "y": rng.integers(0, 9, 48).astype(np.int64),
            "w": rng.random(48).astype(np.float32)}
    ranks = pool.run("torch_input_ranks:local_epoch_cache", DATA2, data, 8,
                     shuffle, 3)
    one = DeviceEpochCache(data, 8, shuffle=shuffle, seed=7)
    for r in ranks:
        assert r["local_batch"] == 4
        rows = slice(4 * r["block"], 4 * r["block"] + 4)
        for e, epoch in enumerate(r["epochs"]):
            want = list(one.batches(e))
            assert len(epoch) == len(want) == 6
            for got, w in zip(epoch, want):
                for k in data:
                    assert got[k].tobytes() == w[k][rows].numpy().tobytes()


def test_cache_verdict_is_and_reduced_over_the_ranks(pool):
    """Each rank budgets its own padded shard; when one rank's
    ``runtime.device_cache_mb`` is below its epoch, every rank streams
    (the reference AND-reduces the verdict), and with room on both every
    rank caches."""
    x, y = _xy(200)
    assert pool.run("torch_input_ranks:cache_verdict", DATA2, x, y,
                    [1024, 1024]) == [True, True]
    assert pool.run("torch_input_ranks:cache_verdict", DATA2, x, y,
                    [1024, 1e-4]) == [False, False]
    assert pool.run("torch_input_ranks:cache_verdict", DATA2, x, y,
                    [1e-4, 1024]) == [False, False]


# -- the learners in a group ---------------------------------------------------

def test_learners_fit_inside_a_two_rank_group_as_alone(pool):
    """LogisticRegression, NaiveBayes and LinearRegression inside a
    two-rank group: each rank fits its own frame on its own device, and
    each fit equals, bit for bit, the same fit in this process, outside
    any group."""
    names = ["LogisticRegression", "NaiveBayes", "LinearRegression"]
    data = []
    for seed in (5, 6):
        x, y = _xy(48, d=4, seed=seed)
        data.append((np.abs(x), y))     # NaiveBayes counts: non-negative
    ranks = pool.run("torch_input_ranks:learner_fits", data, names)
    for rank, got in enumerate(ranks):
        frame = Frame.from_dict({"features": data[rank][0],
                                 "label": data[rank][1]})
        for name in names:
            scored = R.make_learner(tl, name).fit(frame).transform(frame)
            col = "prediction" if name == "LinearRegression" \
                else "probability"
            np.testing.assert_array_equal(got[name],
                                          np.asarray(scored.column(col)),
                                          err_msg=f"rank {rank} {name}")
    assert not np.array_equal(ranks[0]["NaiveBayes"], ranks[1]["NaiveBayes"])


def test_learners_match_the_jax_package_on_a_rank(pool):
    """NaiveBayes fitted on one rank of the group scores as the JAX
    package's NaiveBayes on that rank's frame (rtol 1e-5; its fit is
    closed-form counts)."""
    x, y = _xy(48, d=4, seed=5)
    x = np.abs(x)
    got = pool.run("torch_input_ranks:learner_fits",
                   [(x, y), (x, y)], ["NaiveBayes"])[0]["NaiveBayes"]
    jl = jlearners.NaiveBayes()
    jl.set_params(featuresCol="features", labelCol="label")
    jframe = JFrame.from_dict({"features": x, "label": y})
    want = np.asarray(jl.fit(jframe).transform(jframe).column("probability"))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


# -- run_dataset on a mesh -------------------------------------------------------

def _corpus(tmp_path, n=48, d=4, seed=9):
    rng = np.random.default_rng(seed)
    root = tmp_path / "corpus"
    root.mkdir()
    for i in range(n):
        row = rng.normal(size=d).astype(np.float32)
        label = int(row[0] > 0) + 2 * int(row[1] > 0)
        (root / f"{i:04d}_{label}_.bin").write_bytes(row.tobytes())
    return str(root)


def _linear_init(d=4, k=4, seed=1):
    rng = np.random.default_rng(seed)
    return {"weight": rng.normal(0, 0.3, (k, d)).astype(np.float32),
            "bias": np.zeros(k, np.float32)}


def test_run_dataset_on_a_mesh_resumes_bit_equal(pool, tmp_path):
    """run_dataset at data 2: each rank streams its own half of the corpus
    (``FileSource(process_shard=True)``, 4 rows a rank a step) and saves
    every 5 steps with its own data-state file. Killed while drawing step
    13 and run again, it restores step 10 and each rank's cursor, and its
    final params equal, bit for bit, an uninterrupted run's on both
    ranks."""
    corpus, init = _corpus(tmp_path), _linear_init()
    whole = str(tmp_path / "whole")
    cut = str(tmp_path / "cut")
    os.makedirs(whole)
    os.makedirs(cut)
    want = pool.run("torch_input_ranks:run_dataset", DATA2, corpus, whole,
                    20, 4, init)
    killed = pool.run("torch_input_ranks:run_dataset", DATA2, corpus, cut,
                      20, 4, init, 13)
    assert [k["params"] for k in killed] == [None, None]
    assert {"data_state-10.p0.json", "data_state-10.p1.json"} <= \
        set(killed[0]["data_states"])
    got = pool.run("torch_input_ranks:run_dataset", DATA2, corpus, cut, 20,
                   4, init)
    assert [g["resumed"] for g in got] == [10, 10]
    assert {"data_state-20.p0.json", "data_state-20.p1.json"} <= \
        set(got[0]["data_states"])
    for g, w in zip(got, want):
        for k, v in w["params"].items():
            assert g["params"][k].tobytes() == v.tobytes(), k
    assert want[0]["params"]["weight"].tobytes() == \
        want[1]["params"]["weight"].tobytes()


def test_run_dataset_raises_on_every_rank_when_one_runs_dry(pool, tmp_path):
    """A rank whose stream ends first does not leave the other waiting in
    a collective: both raise, naming the rank and the step."""
    corpus = _corpus(tmp_path, n=24)
    names = sorted(os.listdir(corpus))
    for r, part in enumerate((names[:16], names[16:])):
        os.makedirs(os.path.join(corpus, f"r{r}"))
        for name in part:
            os.rename(os.path.join(corpus, name),
                      os.path.join(corpus, f"r{r}", name))
    ckdir = str(tmp_path / "ck")
    os.makedirs(ckdir)
    errors = pool.run("torch_input_ranks:run_dataset_dry", DATA2, corpus,
                      ckdir, 6, 4, _linear_init(), ["r0", "r1"])
    for e in errors:
        assert "rank(s) [1] ran out of data at step 3 of 6" in e


def test_final_commit_agrees_when_a_rank_lists_late(pool, tmp_path):
    """A meshed loop's final save is made only when the newest committed
    step is not the last; every rank must decide alike, since the save's
    waits are collective. Rank 1 lists the directory 0.5 s late: before
    ``TrainCheckpointer.latest_committed`` it saw the step rank 0 had
    meanwhile committed, skipped the save, and rank 0 waited in a barrier
    for good (the PR 15 reshard test hung so, now and then, under load)."""
    ckdir = str(tmp_path / "ck")
    os.makedirs(ckdir)
    got = pool.run("torch_input_ranks:late_lister", DATA2, ckdir,
                   _linear_init(), 3)
    assert got == [[3], [3]]


# -- the default shard under a mesh -------------------------------------------

def test_process_shard_default_follows_the_data_axes(pool, tmp_path):
    """Under ``runtime.mesh`` data 1 x tensor 2 the two ranks are one data
    block: ``Frame.process_shard()``, ``process_shard=True`` listings and
    ``FileSource(process_shard=True)`` give both the SAME rows (all of
    them). At data 2 each rank keeps its own half."""
    corpus = _corpus(tmp_path, n=10)
    x = np.arange(10, dtype=np.float32)
    same = pool.run("torch_input_ranks:shard_defaults", "data=1,tensor=2",
                    x, corpus)
    for r in same:
        assert r["share"] == (0, 1)
        np.testing.assert_array_equal(r["rows"], x)
        assert len(r["listed"]) == 10 and r["streamed"] == r["listed"]
    assert same[0]["listed"] == same[1]["listed"]
    split = pool.run("torch_input_ranks:shard_defaults", "data=2", x, corpus)
    assert [r["share"] for r in split] == [(0, 2), (1, 2)]
    np.testing.assert_array_equal(
        np.concatenate([r["rows"] for r in split]), x)
    assert split[0]["listed"] + split[1]["listed"] == same[0]["listed"]
