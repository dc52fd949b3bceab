"""The port's learners, trees and AutoML wrappers against the JAX
package's on the CPU.

Both packages featurize the golden CSVs identically
(``tests/test_torch_feature.py``), so each learner sees the same matrix.
The golden datasets fit in one batch (8192 rows), so no shuffle is involved
unless a test asks for streamed batches, which both packages draw from the
same numpy generator. The JAX learners pin a one-device mesh, so their
sums run in one order. Tolerances are stated at each test.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.frame import Frame as JFrame
from mmlspark_tpu.evaluate.compute_model_statistics import (
    ComputeModelStatistics as JComputeModelStatistics,
)
from mmlspark_tpu.io.readers import read_csv as jread_csv
from mmlspark_tpu.train import learners as jl
from mmlspark_tpu.train import train_classifier as jtc
from mmlspark_tpu.train import trees as jtrees
from mmlspark_tpu.utils import config as jconfig
from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.evaluate.compute_model_statistics import (
    ComputeModelStatistics,
)
from mmlspark_tpu_torch.io.readers import read_csv
from mmlspark_tpu_torch.train import learners as tl
from mmlspark_tpu_torch.train import train_classifier as ttc
from mmlspark_tpu_torch.train import trees as ttrees
from mmlspark_tpu_torch.utils import config as tconfig

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
DATASETS = {
    "banknote_like.csv": ("class", True),
    "abalone_like.csv": ("rings_band", False),
    "pima_like.csv": ("diabetes", True),
    "car_eval_like.csv": ("grade", False),
}
BINARY = sorted(d for d, (_, b) in DATASETS.items() if b)
TOL = 5e-3   # the golden harness's (tests/test_golden_metrics.py)


@pytest.fixture(autouse=True)
def on_cpu():
    tconfig.set("runtime.device", "cpu")
    yield
    tconfig.unset("runtime.device")


def _fit_both(dataset, make, cls="TrainClassifier"):
    """(port model, JAX model) of ``make(module)`` through TrainClassifier
    (or TrainRegressor) on one golden CSV."""
    label = DATASETS[dataset][0]
    path = os.path.join(DATA, dataset)
    port = getattr(ttc, cls)(model=make(tl, ttrees), labelCol=label).fit(
        read_csv(path, num_partitions=2))
    ref = getattr(jtc, cls)(model=make(jl, jtrees), labelCol=label).fit(
        jread_csv(path, num_partitions=2))
    return port, ref


def _state(model):
    return model.get("learnerModel")._state


def _scored_both(port, ref, dataset):
    path = os.path.join(DATA, dataset)
    got = port.transform(read_csv(path, num_partitions=2))
    want = ref.transform(jread_csv(path, num_partitions=2))
    return got, want


# -- LogisticRegression -------------------------------------------------------
@pytest.mark.parametrize("dataset", sorted(DATASETS))
@pytest.mark.parametrize("enet", [0.0, 0.5])
def test_logistic_regression_matches_the_jax_fit(dataset, enet):
    """L2 (Adam) and elastic-net (SGD plus the soft-threshold prox),
    maxIter=60: w and b within rtol 1e-4 / atol 1e-5; scored labels
    equal."""
    port, ref = _fit_both(dataset, lambda m, _: m.LogisticRegression(
        maxIter=60, regParam=0.01, elasticNetParam=enet))
    for k in ("w", "b", "mu", "sigma"):
        np.testing.assert_allclose(_state(port)[k], _state(ref)[k],
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    got, want = _scored_both(port, ref, dataset)
    np.testing.assert_array_equal(got.column("scored_labels"),
                                  want.column("scored_labels"))
    np.testing.assert_allclose(np.asarray(got.column("scored_probabilities")),
                               np.asarray(want.column("scored_probabilities")),
                               rtol=1e-4, atol=1e-5)


def test_streamed_logistic_regression_matches_the_jax_fit():
    """An epoch over the ``runtime.device_cache_mb`` budget streams shuffled
    host batches in both packages, drawn from the same numpy generator:
    several batches an epoch, w and b within rtol 1e-4 / atol 1e-5."""
    tconfig.set("runtime.device_cache_mb", 0)
    jconfig.set("runtime.device_cache_mb", 0)
    try:
        port, ref = _fit_both("pima_like.csv", lambda m, _: (
            m.LogisticRegression(maxIter=40, batchSize=64)))
    finally:
        tconfig.unset("runtime.device_cache_mb")
        jconfig.unset("runtime.device_cache_mb")
    for k in ("w", "b"):
        np.testing.assert_allclose(_state(port)[k], _state(ref)[k],
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_resident_epoch_with_several_batches_fits_as_well():
    """With the epoch resident and shuffled on the device, each package
    permutes it with its own generator, so only the fit's quality is
    compared: training accuracy within the golden TOL."""
    port, ref = _fit_both("pima_like.csv", lambda m, _: (
        m.LogisticRegression(maxIter=80, batchSize=64)))
    assert port.get("learnerModel").fit_device == "cpu"
    got, want = _scored_both(port, ref, "pima_like.csv")
    acc = [np.mean(np.asarray(f.column("scored_labels")).astype(str)
                   == np.asarray(f.column("diabetes")).astype(str))
           for f in (got, want)]
    assert abs(acc[0] - acc[1]) <= 2 * TOL


# -- NaiveBayes and LinearRegression ------------------------------------------
@pytest.mark.parametrize("dataset", sorted(DATASETS))
def test_naive_bayes_matches_the_jax_fit(dataset):
    """log_prior and log_cond within 1e-6; scored labels equal."""
    port, ref = _fit_both(dataset, lambda m, _: m.NaiveBayes())
    for k in ("log_prior", "log_cond"):
        np.testing.assert_allclose(_state(port)[k], _state(ref)[k],
                                   rtol=0, atol=1e-6, err_msg=k)
    got, want = _scored_both(port, ref, dataset)
    np.testing.assert_array_equal(got.column("scored_labels"),
                                  want.column("scored_labels"))


def _regression_data(n=600, seed=4):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5))
    y = X @ np.array([1.5, -2.0, 0.5, 0.0, 3.0]) + 0.7 \
        + rng.normal(0, 0.3, n)
    data = {f"x{i}": X[:, i] for i in range(5)}
    data["y"] = y
    return data


@pytest.mark.parametrize("reg", [1e-6, 10.0])
def test_linear_regression_matches_the_jax_fit(reg):
    """Normal equations on well-conditioned data, 3 batches: w and b
    within rtol 1e-4; predictions within rtol 1e-4."""
    data = _regression_data()
    port = ttc.TrainRegressor(model=tl.LinearRegression(
        regParam=reg, batchSize=256), labelCol="y").fit(
        Frame.from_dict(data, num_partitions=2))
    ref = jtc.TrainRegressor(model=jl.LinearRegression(
        regParam=reg, batchSize=256), labelCol="y").fit(
        JFrame.from_dict(data, num_partitions=2))
    np.testing.assert_allclose(_state(port)["w"], _state(ref)["w"],
                               rtol=1e-4)
    np.testing.assert_allclose(_state(port)["b"], _state(ref)["b"],
                               rtol=1e-4)
    got = port.transform(Frame.from_dict(data)).column("scores")
    want = ref.transform(JFrame.from_dict(data)).column("scores")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# -- MLPs from the JAX package's draws ----------------------------------------
def _jax_mlp_init(sizes, seed):
    """The JAX learners' initial draws (``mmlspark_tpu/train/learners.py``,
    ``MLPClassifier.fit``), as host arrays."""
    key = jax.random.PRNGKey(seed)
    params = []
    for i in range(len(sizes) - 1):
        key, k = jax.random.split(key)
        scale = float(np.sqrt(2.0 / sizes[i]))
        params.append({
            "w": np.asarray(jax.random.normal(
                k, (sizes[i], sizes[i + 1]), jnp.float32) * scale),
            "b": np.zeros((sizes[i + 1],), np.float32)})
    return params


@pytest.fixture
def jax_draws(monkeypatch):
    for cls in (tl.MLPClassifier, tl.MLPRegressor):
        monkeypatch.setattr(cls, "_init_params",
                            lambda self, sizes, seed: _jax_mlp_init(sizes,
                                                                    seed))


# 200 Adam steps of an MLP from the same draws: the port's parameters lie
# within 1e-2 (max |difference| over the largest |parameter| of each array)
# of the JAX fit's. Measured: 4.3e-3 at most (abalone's first-layer
# biases; banknote 2.4e-3, car_eval 2.5e-3, pima 4.6e-6, the regressor
# 6.9e-6): Adam divides each gradient by its running RMS, so where a
# gradient is small its last-bit differences become step-sized ones
MLP_PARAM_TOL = 1e-2


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("dataset", sorted(DATASETS))
def test_mlp_classifier_from_jax_draws_matches_the_jax_fit(dataset,
                                                           jax_draws):
    """The golden constructor (maxIter=200, layers=[16], seed=3) from the
    JAX draws: parameters within MLP_PARAM_TOL, and accuracy and AUC within
    the golden TOL of the JAX fit in the same run. This holds the two
    ENV_DRIFT cells of tests/test_golden_metrics.py (abalone, banknote),
    whose golden values drift with the toolchain, against the reference."""
    port, ref = _fit_both(dataset, lambda m, _: m.MLPClassifier(
        maxIter=200, layers=[16], seed=3))
    for g, w in zip(_state(port)["layers"], _state(ref)["layers"]):
        for k in ("w", "b"):
            assert _max_rel(g[k], w[k]) <= MLP_PARAM_TOL, k
    got, want = _scored_both(port, ref, dataset)
    m_got = ComputeModelStatistics().transform(got).head(1)[0]
    m_want = JComputeModelStatistics().transform(want).head(1)[0]
    for k in ("accuracy", "AUC"):
        if k in m_want:
            assert abs(float(m_got[k]) - float(m_want[k])) <= TOL, k


def test_mlp_regressor_from_jax_draws_matches_the_jax_fit(jax_draws):
    """MLPRegressor (layers [8], 100 steps) from the JAX draws: parameters
    within MLP_PARAM_TOL, predictions within 1e-3 of the label scale."""
    data = _regression_data(n=300)
    make = lambda m: m.MLPRegressor(layers=[8], maxIter=100, seed=2)  # noqa
    port = ttc.TrainRegressor(model=make(tl), labelCol="y").fit(
        Frame.from_dict(data))
    ref = jtc.TrainRegressor(model=make(jl), labelCol="y").fit(
        JFrame.from_dict(data))
    for g, w in zip(_state(port)["layers"], _state(ref)["layers"]):
        for k in ("w", "b"):
            assert _max_rel(g[k], w[k]) <= MLP_PARAM_TOL, k
    got = port.transform(Frame.from_dict(data)).column("scores")
    want = ref.transform(JFrame.from_dict(data)).column("scores")
    assert np.abs(got - want).max() <= 1e-3 * np.abs(data["y"]).max()


def test_mlp_init_is_seeded():
    a = tl.MLPClassifier()._init_params([5, 4, 2], 7)
    b = tl.MLPClassifier()._init_params([5, 4, 2], 7)
    c = tl.MLPClassifier()._init_params([5, 4, 2], 8)
    assert all(np.array_equal(x["w"], y["w"]) for x, y in zip(a, b))
    assert not np.array_equal(a[0]["w"], c[0]["w"])
    assert a[0]["w"].shape == (5, 4) and a[1]["b"].shape == (2,)


# -- grow_tree and predict_leaves ---------------------------------------------
def _binned(n=500, F=6, B=16, seed=0):
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0, B, size=(n, F)).astype(np.int32)
    score = Xb[:, 0] - Xb[:, 3] + rng.normal(0, 3, n)
    return rng, Xb, score


def _grow_both(Xb, V, w, mask, depth, B, lam, min_w, counts=None):
    got = ttrees.grow_tree(
        torch.from_numpy(Xb), torch.from_numpy(V), torch.from_numpy(w),
        torch.from_numpy(mask), depth, B, lam, min_w,
        None if counts is None else torch.from_numpy(counts))
    want = jax.jit(jtrees.grow_tree, static_argnums=(4, 5))(
        jnp.asarray(Xb), jnp.asarray(V), jnp.asarray(w), jnp.asarray(mask),
        depth, B, lam, min_w, None if counts is None else jnp.asarray(counts))
    return [g.numpy() for g in got], [np.asarray(x) for x in want]


GROW_CASES = ["gini", "gini_bootstrap_masked", "variance", "newton"]


@pytest.mark.parametrize("case", GROW_CASES)
def test_grow_tree_matches_the_jax_grower(case):
    """feats, bins and the leaf assignment equal; leaf sums within 1e-5
    relative (each leaf channel against its largest magnitude)."""
    rng, Xb, score = _binned()
    n, F = Xb.shape
    mask = np.ones(F, bool)
    w = np.ones(n, np.float32)
    counts = None
    if case.startswith("gini"):
        V = np.eye(3, dtype=np.float32)[np.digitize(score, [-3, 3])]
        if case == "gini_bootstrap_masked":
            w = rng.multinomial(n, np.full(n, 1 / n)).astype(np.float32)
            V = V * w[:, None]
            mask[[1, 4]] = False
    elif case == "variance":
        V = score.astype(np.float32)[:, None]
    else:
        p = 1 / (1 + np.exp(-score / 4))
        y = (rng.random(n) < p).astype(np.float32)
        V = (y - 0.5)[:, None].astype(np.float32) * -1
        w = np.full(n, 0.25, np.float32)
        counts = np.ones(n, np.float32)
    got, want = _grow_both(Xb, V, w, mask, 4, 16, 1e-6, 2.0, counts)
    for i, name in ((0, "feats"), (1, "bins"), (4, "node")):
        np.testing.assert_array_equal(got[i], want[i], err_msg=name)
    for i, name in ((2, "leaf_V"), (3, "leaf_w")):
        scale = max(np.abs(want[i]).max(), 1e-30)
        assert np.abs(got[i] - want[i]).max() <= 1e-5 * scale, name


def test_grow_trees_batches_the_forest_as_separate_fits():
    """The tree axis of grow_trees gives each tree what grow_tree gives it
    alone (the JAX package vmaps the one-tree grower)."""
    rng, Xb, score = _binned(seed=2)
    n, F = Xb.shape
    V = np.eye(2, dtype=np.float32)[(score > 0).astype(int)]
    W = rng.multinomial(n, np.full(n, 1 / n), size=3).astype(np.float32)
    masks = rng.random((3, F)) < 0.7
    Xt = torch.from_numpy(Xb).to(torch.int64)
    batched = ttrees.grow_trees(
        Xt, torch.from_numpy(V[None] * W[:, :, None]), torch.from_numpy(W),
        torch.from_numpy(masks), 3, 16, 1e-6, 1.0)
    for t in range(3):
        one = ttrees.grow_tree(Xt, torch.from_numpy(V * W[t][:, None]),
                               torch.from_numpy(W[t]),
                               torch.from_numpy(masks[t]), 3, 16, 1e-6, 1.0)
        for b, o in zip(batched, one):
            assert torch.equal(b[t], o)


def test_predict_leaves_matches_the_jax_walk():
    rng = np.random.default_rng(9)
    X = rng.normal(size=(200, 5)).astype(np.float32)
    X[::17, 2] = np.nan                                # NaN routes left
    feats = rng.integers(0, 5, 15).astype(np.int32)
    thrs = rng.normal(size=15).astype(np.float32)
    thrs[[4, 9]] = np.inf                              # dead ends
    got = ttrees.predict_leaves(torch.from_numpy(X), torch.from_numpy(feats),
                                torch.from_numpy(thrs), 4).numpy()
    want = np.asarray(jtrees.predict_leaves(jnp.asarray(X),
                                            jnp.asarray(feats),
                                            jnp.asarray(thrs), 4))
    np.testing.assert_array_equal(got, want)


def test_host_binning_is_the_jax_packages():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(300, 4)).astype(np.float32)
    X[:, 1] = rng.integers(0, 5, 300)
    X[5, 0] = np.nan
    for B in (4, 32):
        edges = ttrees.make_bin_edges(X, B)
        np.testing.assert_array_equal(edges, jtrees.make_bin_edges(X, B))
        np.testing.assert_array_equal(ttrees.bin_features(X, edges),
                                      jtrees.bin_features(X, edges))
    for strategy in ("auto", "all", "sqrt", "log2", "onethird"):
        np.testing.assert_array_equal(
            ttrees._feature_masks(9, 4, strategy, True,
                                  np.random.default_rng(0)),
            jtrees._feature_masks(9, 4, strategy, True,
                                  np.random.default_rng(0)))


# -- tree learners on the golden CSVs -----------------------------------------
TREE_LEARNERS = {
    "DecisionTree": lambda m, t: t.DecisionTreeClassifier(maxDepth=5),
    "RandomForest": lambda m, t: t.RandomForestClassifier(
        numTrees=16, maxDepth=5, seed=7),
    "GBT": lambda m, t: t.GBTClassifier(maxIter=20, maxDepth=3),
}
TREE_CELLS = [(d, l) for d in sorted(DATASETS) for l in sorted(TREE_LEARNERS)
              if l != "GBT" or DATASETS[d][1]]


def _node_gains(Xb, g, h, feats, bins, node_id, B, lam):
    """float64 Newton gains of every (feature, bin) split at BFS node
    ``node_id`` of a tree whose ancestors split on (feats, bins), for
    gradients ``g`` and hessians ``h`` (a row counts once toward the
    one-row minimum of each child)."""
    depth = int(np.log2(node_id + 1))
    node = np.zeros(len(g), int)
    for d in range(depth):
        off = (1 << d) - 1
        node = 2 * node + (Xb[np.arange(len(g)), feats[off + node]]
                           > bins[off + node])
    rows = node == node_id - ((1 << depth) - 1)
    gains = np.full((Xb.shape[1], B), -np.inf)
    for f in range(Xb.shape[1]):
        col = Xb[rows, f]
        cv = np.cumsum(np.bincount(col, weights=-g[rows], minlength=B))
        cw = np.cumsum(np.bincount(col, weights=h[rows], minlength=B))
        cc = np.cumsum(np.bincount(col, minlength=B))
        gain = cv ** 2 / (cw + lam) + (cv[-1] - cv) ** 2 / (cw[-1] - cw + lam)
        ok = (cc >= 1) & (cc[-1] - cc >= 1)
        ok[-1] = False
        gains[f] = np.where(ok, gain, -np.inf)
    return gains


def _split_bins(feats, thrs, edges):
    B = edges.shape[1] + 1
    return np.asarray([np.searchsorted(edges[f], t) if np.isfinite(t)
                       else B - 1 for f, t in zip(feats, thrs)])


def _assert_boosting_ties(port, ref, dataset, flips):
    """Each (round, node) where the port's boosted tree splits otherwise
    than the JAX fit's is a tie on the JAX side: with the JAX model's
    margins before that round, the float64 gains of the two splits agree
    within 1e-9 relative (fp32 sums of equal gains differ in the last
    bits, and argmax then takes either)."""
    import torch
    from mmlspark_tpu_torch.feature.value_indexer import ValueIndexer
    label = DATASETS[dataset][0]
    frame = read_csv(os.path.join(DATA, dataset)).na_drop([label])
    indexed = ValueIndexer(inputCol=label, outputCol="_y").fit(
        frame).transform(frame)
    featurized = port.get("featurizeModel").transform(indexed)
    X = np.asarray(featurized.column(port._state["features_col"]),
                   np.float32)
    y = np.asarray(featurized.column("_y"), np.float64)
    got, want = _state(port), _state(ref)
    edges = ttrees.make_bin_edges(X, 32)
    Xb = ttrees.bin_features(X, edges)
    for r, k in flips:
        a = k
        while a:                     # the node's ancestors split alike
            a = (a - 1) // 2
            assert got["feats"][r][a] == want["feats"][r][a]
            assert got["thrs"][r][a] == want["thrs"][r][a]
        margin = np.full(len(y), want["base"])
        for i in range(r):
            leaves = ttrees.predict_leaves(
                torch.from_numpy(X), torch.from_numpy(want["feats"][i]),
                torch.from_numpy(want["thrs"][i]), want["depth"]).numpy()
            margin += want["scale"] * want["values"][i][leaves]
        p = 1 / (1 + np.exp(-margin))
        jb = _split_bins(want["feats"][r], want["thrs"][r], edges)
        pb = _split_bins(got["feats"][r], got["thrs"][r], edges)
        gains = _node_gains(Xb, p - y, p * (1 - p), want["feats"][r], jb, k,
                            32, 1e-6)
        g_jax = gains[want["feats"][r][k], jb[k]]
        g_port = gains[got["feats"][r][k], pb[k]]
        assert abs(g_port - g_jax) <= 1e-9 * abs(g_jax), (r, k, g_port,
                                                           g_jax)


@pytest.mark.parametrize("dataset,learner", TREE_CELLS)
def test_tree_classifier_matches_the_jax_fit(dataset, learner):
    """Equal structure (feats, thresholds), leaf values and probabilities
    within 1e-5, scored labels equal. The gini histograms sum
    integer-valued weights, exactly in both packages. The boosted ones sum
    float gradients that differ from the JAX package's in the last bits
    (its sigmoid, its cumulative sum), so a split may flip where two
    candidates tie: each such flip is asserted to be a tie
    (``_assert_boosting_ties``; on banknote and pima the tied splits cut
    the training rows alike, so the margins go on equal)."""
    port, ref = _fit_both(dataset, TREE_LEARNERS[learner])
    got, want = _state(port), _state(ref)
    flips = np.argwhere((got["feats"] != want["feats"])
                        | (got["thrs"] != want["thrs"]))
    if learner == "GBT":
        _assert_boosting_ties(port, ref, dataset, flips)
    else:
        assert flips.size == 0
    for k in ("leaf_probs", "values"):
        if k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5)
    s_got, s_want = _scored_both(port, ref, dataset)
    np.testing.assert_array_equal(s_got.column("scored_labels"),
                                  s_want.column("scored_labels"))
    np.testing.assert_allclose(
        np.asarray(s_got.column("scored_probabilities")),
        np.asarray(s_want.column("scored_probabilities")), rtol=0, atol=1e-5)


REGRESSION_TREES = {
    "DecisionTreeRegressor": lambda m: m.DecisionTreeRegressor(maxDepth=4),
    "RandomForestRegressor": lambda m: m.RandomForestRegressor(
        numTrees=5, maxDepth=4, seed=1),
    "GBTRegressor": lambda m: m.GBTRegressor(maxIter=10, maxDepth=3),
}


@pytest.mark.parametrize("name", sorted(REGRESSION_TREES))
def test_tree_regressor_matches_the_jax_fit(name):
    """Equal structure; leaf values and predictions within 1e-5 relative
    to the label scale."""
    data = _regression_data(n=400, seed=8)
    port = ttc.TrainRegressor(model=REGRESSION_TREES[name](ttrees),
                              labelCol="y").fit(Frame.from_dict(data))
    ref = jtc.TrainRegressor(model=REGRESSION_TREES[name](jtrees),
                             labelCol="y").fit(JFrame.from_dict(data))
    got, want = _state(port), _state(ref)
    np.testing.assert_array_equal(got["feats"], want["feats"])
    np.testing.assert_array_equal(got["thrs"], want["thrs"])
    scale = np.abs(data["y"]).max()
    assert np.abs(got["values"] - want["values"]).max() <= 1e-5 * scale
    p_got = port.transform(Frame.from_dict(data)).column("scores")
    p_want = ref.transform(JFrame.from_dict(data)).column("scores")
    assert np.abs(p_got - p_want).max() <= 1e-5 * scale


# -- one device only -----------------------------------------------------------
@pytest.mark.parametrize("make", [
    lambda: tl.LogisticRegression(maxIter=2), lambda: tl.NaiveBayes(),
    lambda: ttrees.DecisionTreeClassifier(maxDepth=2)])
def test_learners_refuse_a_multi_process_group(monkeypatch, make):
    """Inside a torch.distributed group of more than one process a fit no
    longer refuses: each rank fits the frame it was given on its own
    device, as the reference's learners fit each process's frame on its
    first local device, and the fit equals the same fit outside a group
    (the two-rank run is in tests/test_torch_multiprocess.py)."""
    import torch.distributed as dist
    frame = Frame.from_dict({"features": np.eye(4, dtype=np.float32),
                             "label": np.array([0, 1, 0, 1])})

    def fit():
        learner = make()
        learner.set_params(featuresCol="features", labelCol="label")
        return learner.fit(frame).transform(frame).column("probability")
    alone = fit()
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    np.testing.assert_array_equal(fit(), alone)
