"""Tree learners: DecisionTree / RandomForest / GBT, classifier + regressor.

The port of ``mmlspark_tpu/train/trees.py``. Capability parity with the
MLlib tree learners the reference's TrainClassifier/TrainRegressor accept
(``TrainClassifier.scala:94-150``, ``TrainRegressor.scala:43-117``):

- A tree is grown LEVEL-WISE on the device: one accumulating scatter
  (:func:`_scatter_add`) builds the (tree, node, feature, bin)
  histogram of the whole level, a cumulative sum turns it into every
  candidate split's left/right statistics, and an argmax picks the best
  split per node.
- A random forest grows its T trees together: the tree is an axis of the
  histogram's index (the JAX package ``vmap``s the one-tree grower), so a
  level of the forest is one scatter, not T.
- Features are quantile-binned once on the host into a uint8 matrix, which
  crosses to the device as bytes and is widened there. The model stores
  real-valued thresholds so scoring needs no binning.

One histogram engine serves all six learners: statistics are C "value"
channels plus a weight channel; split gain is sum_c VL_c^2/(WL+lam) +
sum_c VR_c^2/(WR+lam), which specializes to gini gain (V=class one-hots),
variance reduction (V=y), and the XGBoost gradient gain (V=g, W=h).

Trees are perfect binary trees of static ``maxDepth``: a node that cannot
improve routes all rows left (threshold=+inf) and both children inherit its
leaf value.

Determinism: a float scatter-add sums in no fixed order unless it is
told to, so :func:`_scatter_add` picks each device's ordered one: on a
CUDA tensor ``index_put_(accumulate=True)`` sorts the flat indices (a
stable radix sort) and sums each index's values in row order; on the CPU
``index_add_`` over a flat index is a serial loop in row order, the order
of the JAX package's scatter (the CPU's ``index_put_`` accumulates in
parallel, in no fixed order). So two fits of the same frame build the same
histograms bit for bit and choose the same splits, even on near-ties
(``chip_smoke.py`` checks it on the card). A fit reads nothing back from the device until its trees come home in
one counted fetch (``learner.trees``), boosting's rounds included.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.core.params import (
    FloatParam, HasFeaturesCol, HasLabelCol, IntParam, StringParam,
)
from mmlspark_tpu_torch.core.pipeline import Model
from mmlspark_tpu_torch.core.serialization import register_stage
from mmlspark_tpu_torch.observability import syncs as obssyncs
from mmlspark_tpu_torch.train.learners import (
    FeaturizeHints, TorchEstimator, _on_device, _score_classifier,
    _score_regressor,
)
from mmlspark_tpu_torch.utils.config import resolve_device

_NEG = -1e30  # masked-gain sentinel (finite: -inf breaks argmax ties)


# --------------------------------------------------------------------------
# host-side quantile binning
def make_bin_edges(X: np.ndarray, max_bins: int) -> np.ndarray:
    """Per-feature ascending split candidates, (F, max_bins-1) float32.

    Quantile edges over finite values; features with fewer distinct values
    pad with +inf (empty bins are harmless). Row bin b means
    ``edges[f, b-1] < x <= edges[f, b]``; going right at split b tests
    ``x > edges[f, b]``.
    """
    n, F = X.shape
    B = max_bins
    edges = np.full((F, B - 1), np.inf, dtype=np.float32)
    qs = np.linspace(0, 1, B + 1)[1:-1]
    for f in range(F):
        col = X[:, f]
        col = col[np.isfinite(col)]
        if col.size == 0:
            continue
        uniq = np.unique(col)
        if uniq.size <= 1:
            continue
        if uniq.size <= B - 1:
            # exact midpoints between consecutive distinct values
            mids = (uniq[:-1] + uniq[1:]) / 2.0
            edges[f, :mids.size] = mids
        else:
            cand = np.unique(np.quantile(col, qs))
            edges[f, :cand.size] = cand
    return edges


def bin_features(X: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Bin rows against edges; NaN maps to the left-most bin (scoring sends
    NaN left because ``NaN > t`` is False — keep fit consistent)."""
    Xc = np.nan_to_num(X, nan=-np.inf, posinf=np.finfo(np.float32).max)
    F = X.shape[1]
    out = np.empty(X.shape, dtype=np.int32)
    for f in range(F):
        out[:, f] = np.searchsorted(edges[f], Xc[:, f], side="left")
    return out


# --------------------------------------------------------------------------
# the level-wise grower, batched over a leading tree axis
def _scatter_add(out: torch.Tensor, idx: torch.Tensor,
                 src: torch.Tensor) -> torch.Tensor:
    """``out[idx[i]] += src[i]`` for the rows of (M, K) ``out`` and (N, K)
    ``src``, summing each row's updates in the order of ``i`` on either
    device (module docstring)."""
    if out.device.type == "cuda":
        return out.index_put_((idx,), src, accumulate=True)
    k = out.shape[1]
    flat = (idx[:, None] * k + torch.arange(k, device=idx.device)).reshape(-1)
    out.view(-1).index_add_(0, flat, src.reshape(-1))  # lint: allow-embed (histograms)
    return out


def grow_trees(Xb: torch.Tensor, V: torch.Tensor, w: torch.Tensor,
               feat_mask: torch.Tensor, depth: int, n_bins: int,
               lam: float, min_child_weight: float,
               counts: Optional[torch.Tensor] = None):
    """Grow T depth-``depth`` trees over the same binned rows at once.

    Xb (n, F) int64 binned features, shared by every tree; V (T, n, C)
    value channels; w (T, n) weights (0-weight rows are ignored — that is
    how bootstrap/boosting masks rows); feat_mask (T, F) bool selects each
    tree's splittable features. ``counts`` (T, n), when given, is the
    channel the min-child test uses instead of ``w`` — boosting's w carries
    hessians, but minInstancesPerNode means ROWS.

    Returns (feats (T, 2^depth-1), bins (T, 2^depth-1), leaf_V (T, 2^depth,
    C), leaf_w (T, 2^depth), node (T, n) final leaf assignment).
    """
    n, F = Xb.shape
    T, _, C = V.shape
    B = n_bins
    dev = Xb.device
    chans = [V, w[..., None]]
    if counts is not None:
        chans.append(counts[..., None])
    S = torch.cat(chans, dim=2)                             # (T, n, K)
    n_chan = S.shape[2]
    node = torch.zeros((T, n), dtype=torch.int64, device=dev)
    tree = torch.arange(T, device=dev)[:, None]             # (T, 1)
    rows = torch.arange(n, device=dev)[None, :]             # (1, n)
    col_idx = torch.arange(F, device=dev)[None, None, :]    # (1, 1, F)
    feats_levels, bins_levels = [], []
    for d in range(depth):
        n_nodes = 1 << d
        # histogram over (tree, node, feature, bin), all channels at once
        idx = (((tree * n_nodes + node)[..., None] * F + col_idx) * B
               + Xb[None]).reshape(-1)
        vals = S[:, :, None, :].expand(T, n, F, n_chan).reshape(-1, n_chan)
        hist = torch.zeros((T * n_nodes * F * B, n_chan), dtype=S.dtype,
                           device=dev)
        _scatter_add(hist, idx, vals)
        hist = hist.reshape(T, n_nodes, F, B, n_chan)

        cum = torch.cumsum(hist, dim=3)                     # (T, N, F, B, K)
        total = cum[:, :, :, -1:, :]
        SL, SR = cum, total - cum
        VL, WL = SL[..., :C], SL[..., C]
        VR, WR = SR[..., :C], SR[..., C]
        gain = ((VL ** 2).sum(-1) / (WL + lam)
                + (VR ** 2).sum(-1) / (WR + lam))           # (T, N, F, B)
        CL = SL[..., -1] if counts is not None else WL
        CR = SR[..., -1] if counts is not None else WR
        ok = (CL >= min_child_weight) & (CR >= min_child_weight)
        ok &= feat_mask[:, None, :, None]
        ok[..., B - 1] = False                              # last bin: no split
        gain = torch.where(ok, gain, torch.full_like(gain, _NEG))

        flat = gain.reshape(T, n_nodes, F * B)
        best = torch.argmax(flat, dim=2)   # first maximum, as jnp.argmax
        best_gain = torch.gather(flat, 2, best[..., None])[..., 0]
        feat = best // B
        bin_ = best % B
        # No VALID candidate (all masked) -> dead-end: route everything
        # left. A valid split never loses gain (sum V^2/W is
        # superadditive), and zero-gain splits stay allowed or XOR-like
        # targets never get resolved by depth 2.
        splittable = best_gain > _NEG / 2
        feat = torch.where(splittable, feat, torch.zeros_like(feat))
        bin_ = torch.where(splittable, bin_, torch.full_like(bin_, B - 1))
        feats_levels.append(feat)
        bins_levels.append(bin_)

        row_feat = torch.gather(feat, 1, node)               # (T, n)
        row_bin = torch.gather(bin_, 1, node)
        go_right = Xb[rows, row_feat] > row_bin
        node = 2 * node + go_right.to(torch.int64)

    n_leaves = 1 << depth
    leaf_S = torch.zeros((T * n_leaves, n_chan), dtype=S.dtype, device=dev)
    _scatter_add(leaf_S, (tree * n_leaves + node).reshape(-1),
                 S.reshape(-1, n_chan))
    leaf_S = leaf_S.reshape(T, n_leaves, n_chan)
    empty = torch.zeros((T, 0), dtype=torch.int64, device=dev)
    feats = torch.cat(feats_levels, dim=1) if depth else empty
    bins = torch.cat(bins_levels, dim=1) if depth else empty
    return feats, bins, leaf_S[..., :C], leaf_S[..., C], node


def grow_tree(Xb: torch.Tensor, V: torch.Tensor, w: torch.Tensor,
              feat_mask: torch.Tensor, depth: int, n_bins: int,
              lam: float, min_child_weight: float,
              counts: Optional[torch.Tensor] = None):
    """Grow one depth-``depth`` tree: :func:`grow_trees` with one tree.

    Xb (n, F) int binned features; V (n, C) value channels; w (n,)
    weights; feat_mask (F,) bool; ``counts`` (n,) the min-child channel.
    Returns (feats (2^depth-1,), bins (2^depth-1,), leaf_V (2^depth, C),
    leaf_w (2^depth,), node (n,))."""
    out = grow_trees(Xb.to(torch.int64), V[None], w[None], feat_mask[None],
                     depth, n_bins, lam, min_child_weight,
                     None if counts is None else counts[None])
    return tuple(t[0] for t in out)


def bins_to_thresholds(feats: np.ndarray, bins: np.ndarray,
                       edges: np.ndarray) -> np.ndarray:
    """Split-bin indices -> real thresholds (+inf for dead-end nodes)."""
    B = edges.shape[1] + 1
    thr = np.where(bins >= B - 1, np.inf,
                   edges[feats, np.minimum(bins, B - 2)])
    return thr.astype(np.float32)


def predict_leaves_trees(X: torch.Tensor, feats: torch.Tensor,
                         thrs: torch.Tensor, depth: int) -> torch.Tensor:
    """Leaf index per tree and row, (T, n), for T trees of (T, 2^depth-1)
    ``feats`` / ``thrs`` (NaN routes left)."""
    T, n = feats.shape[0], X.shape[0]
    node = torch.zeros((T, n), dtype=torch.int64, device=X.device)
    rows = torch.arange(n, device=X.device)[None, :]
    for d in range(depth):
        offset = (1 << d) - 1
        f = torch.gather(feats, 1, offset + node)
        t = torch.gather(thrs, 1, offset + node)
        node = 2 * node + (X[rows, f] > t).to(torch.int64)
    return node


def predict_leaves(X: torch.Tensor, feats: torch.Tensor, thrs: torch.Tensor,
                   depth: int) -> torch.Tensor:
    """Leaf index per row for one tree (NaN routes left)."""
    return predict_leaves_trees(X, feats.to(torch.int64)[None], thrs[None],
                                depth)[0]


# --------------------------------------------------------------------------
# shared learner plumbing
_TREE_HINTS = FeaturizeHints(one_hot=False, num_features=1 << 12)


def _feature_masks(F: int, n_trees: int, strategy: str, is_classifier: bool,
                   rng: np.random.Generator) -> np.ndarray:
    """Per-tree boolean feature masks (Spark featureSubsetStrategy).

    'auto' resolves to 'all' for a single tree, else sqrt (classification) /
    onethird (regression); an EXPLICIT strategy is honored even for one tree.
    """
    if strategy == "auto":
        strategy = ("all" if n_trees == 1
                    else "sqrt" if is_classifier else "onethird")
    if strategy == "all":
        return np.ones((n_trees, F), bool)
    k = {"sqrt": max(1, int(np.sqrt(F))),
         "log2": max(1, int(np.log2(F))),
         "onethird": max(1, F // 3)}.get(strategy)
    if k is None:
        raise ValueError(f"unknown featureSubsetStrategy {strategy!r}")
    masks = np.zeros((n_trees, F), bool)
    for t in range(n_trees):
        masks[t, rng.choice(F, size=min(k, F), replace=False)] = True
    return masks


_BIN_SAMPLE_ROWS = 1 << 18  # rows sampled for quantile edges (LightGBM-style)


def _device_bins(Xb: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint8 bin matrix -> int64 ON THE DEVICE: 1 byte a cell crosses to
    the device (the histogram's index arithmetic needs int64, the wire
    does not)."""
    return torch.from_numpy(np.ascontiguousarray(Xb)).to(device).to(
        torch.int64)


class _TreeParams(TorchEstimator):
    maxDepth = IntParam("maxDepth", "maximum tree depth", 5,
                        validator=lambda v: 1 <= v <= 12)
    maxBins = IntParam("maxBins", "maximum feature histogram bins", 32,
                       validator=lambda v: 2 <= v <= 256)
    minInstancesPerNode = IntParam(
        "minInstancesPerNode", "minimum (weighted) rows per child", 1)
    lam = FloatParam("lam", "leaf/gain L2 regularization", 1e-6)
    hints = _TREE_HINTS

    def _prep(self, frame: Frame):
        """Streamed histogram prep: (y, edges, Xb-uint8).

        Histogram CART needs global quantile bins, but NOT the fp32 matrix:
        edges come from a seeded row SAMPLE streamed off the frame (exact
        below ``_BIN_SAMPLE_ROWS`` rows, sampled above), then a second
        streaming pass bins every row into a uint8 matrix.
        """
        fcol, lcol = self.featuresCol, self.labelCol
        n = frame.count()
        if n == 0:
            raise ValueError(f"{type(self).__name__}: empty frame")
        take = min(1.0, _BIN_SAMPLE_ROWS / n)
        rng = np.random.default_rng(0)
        sample: List[np.ndarray] = []
        ys: List[np.ndarray] = []
        F = None
        for hb in frame.batches(1 << 16, cols=[fcol, lcol]):
            x = np.asarray(hb[fcol], np.float32)
            if x.ndim != 2:
                raise ValueError(f"features column {fcol!r} must be a "
                                 "vector column")
            F = x.shape[1]
            ys.append(np.asarray(hb[lcol]))
            sample.append(x if take >= 1.0
                          else x[rng.random(len(x)) < take])
        y = np.concatenate(ys)
        full = np.concatenate(sample) if len(sample) > 1 else sample[0]
        edges = make_bin_edges(full, self.maxBins)
        if take >= 1.0:
            # the "sample" IS the whole frame in order — bin it directly
            Xb = np.empty((n, F), np.uint8)
            Xb[:] = bin_features(full, edges)
            return y, edges, Xb
        del sample, full
        Xb = np.empty((n, F), np.uint8)  # maxBins <= 256 -> bins fit uint8
        off = 0
        for hb in frame.batches(1 << 16, cols=[fcol]):
            x = np.asarray(hb[fcol], np.float32)
            Xb[off:off + len(x)] = bin_features(x, edges)
            off += len(x)
        return y, edges, Xb

    def _grow(self, Xb: np.ndarray, V: np.ndarray, w: np.ndarray,
              masks: np.ndarray):
        """Grow ``len(masks)`` trees on the device: V (T, n, C) or (n, C)
        shared, w (T, n). Returns host (feats, bins, leaf_V, leaf_w) in one
        counted fetch, and the device the bins lay on."""
        device = resolve_device()
        Xb_d = _device_bins(Xb, device)
        w_d = _on_device(w, device)
        V_d = _on_device(V, device)
        if V_d.dim() == 2:
            V_d = V_d[None] * w_d[:, :, None]
        feats, bins, leaf_V, leaf_w, _ = grow_trees(
            Xb_d, V_d, w_d, torch.as_tensor(masks, device=device),
            self.maxDepth, self.maxBins, self.lam,
            float(self.minInstancesPerNode))
        host = obssyncs.device_get((feats, bins, leaf_V, leaf_w),
                                   "learner.trees")
        return host, str(Xb_d.device)


def _leaf_probs(leaf_V: np.ndarray, leaf_w: np.ndarray,
                n_classes: int) -> np.ndarray:
    """Class distribution per leaf; empty leaves get the uniform prior."""
    w = leaf_w[..., None]
    probs = np.where(w > 0, leaf_V / np.maximum(w, 1e-12), 1.0 / n_classes)
    return probs.astype(np.float32)


def _thresholds(feats: np.ndarray, bins: np.ndarray,
                edges: np.ndarray) -> np.ndarray:
    return np.stack([bins_to_thresholds(f, b, edges)
                     for f, b in zip(feats, bins)])


# --------------------------------------------------------------------------
@register_stage
class DecisionTreeClassifier(_TreeParams):
    """Single CART tree: gini-gain splits, leaf = class distribution."""

    def fit(self, frame: Frame) -> "TreeClassifierModel":
        y, edges, Xb = self._prep(frame)
        y = y.astype(np.int32)
        K = self._num_classes(frame, y)
        n, F = Xb.shape
        V = np.eye(K, dtype=np.float32)[y]
        (feats, bins, leaf_V, leaf_w), on = self._grow(
            Xb, V, np.ones((1, n), np.float32), np.ones((1, F), bool))
        model = TreeClassifierModel(featuresCol=self.featuresCol,
                                    labelCol=self.labelCol)
        model._state = {
            "feats": feats, "thrs": _thresholds(feats, bins, edges),
            "leaf_probs": _leaf_probs(leaf_V, leaf_w, K),
            "depth": self.maxDepth, "n_classes": K}
        model.fit_device = on
        return model


@register_stage
class RandomForestClassifier(_TreeParams):
    """Bootstrap forest of gini trees, the trees grown together."""

    numTrees = IntParam("numTrees", "number of trees", 20,
                        validator=lambda v: v >= 1)
    featureSubsetStrategy = StringParam(
        "featureSubsetStrategy", "features considered per tree",
        "auto", domain=["auto", "all", "sqrt", "log2", "onethird"])
    subsamplingRate = FloatParam("subsamplingRate", "bootstrap sample rate", 1.0)
    seed = IntParam("seed", "random seed", 0)

    def fit(self, frame: Frame) -> "TreeClassifierModel":
        y, edges, Xb = self._prep(frame)
        y = y.astype(np.int32)
        K = self._num_classes(frame, y)
        n, F = Xb.shape
        T = self.numTrees
        rng = np.random.default_rng(self.seed)
        V = np.eye(K, dtype=np.float32)[y]
        # multinomial bootstrap as per-row weights
        draws = max(1, int(round(n * self.subsamplingRate)))
        weights = rng.multinomial(
            draws, np.full(n, 1.0 / n), size=T).astype(np.float32)
        masks = _feature_masks(F, T, self.featureSubsetStrategy, True, rng)
        (feats, bins, leaf_V, leaf_w), on = self._grow(Xb, V, weights, masks)
        model = TreeClassifierModel(featuresCol=self.featuresCol,
                                    labelCol=self.labelCol)
        model._state = {
            "feats": feats, "thrs": _thresholds(feats, bins, edges),
            "leaf_probs": _leaf_probs(leaf_V, leaf_w, K),
            "depth": self.maxDepth, "n_classes": K}
        model.fit_device = on
        return model


class _TreeScorer:
    """Device copies of a fitted ensemble's ``feats`` / ``thrs``."""

    def _trees(self, device):
        feats = torch.as_tensor(np.asarray(self._state["feats"]),
                                dtype=torch.int64, device=device)
        thrs = _on_device(self._state["thrs"], device)
        return feats, thrs, int(self._state["depth"])


@register_stage
class TreeClassifierModel(_TreeScorer, HasFeaturesCol, HasLabelCol, Model):
    """Scores by averaging leaf class distributions over trees (T>=1)."""

    def scores_fn(self):
        device = resolve_device()
        feats, thrs, depth = self._trees(device)
        probs = _on_device(self._state["leaf_probs"], device)  # (T, 2^D, K)
        tree = torch.arange(probs.shape[0], device=device)[:, None]

        @torch.inference_mode()
        def f(X):
            leaves = predict_leaves_trees(X, feats, thrs, depth)  # (T, n)
            p = probs[tree, leaves].mean(dim=0)                  # (n, K)
            return torch.log(p + 1e-12), p
        return f

    def transform(self, frame: Frame) -> Frame:
        return _score_classifier(self, frame)


# --------------------------------------------------------------------------
def _leaf_values(leaf_V: np.ndarray, leaf_w: np.ndarray,
                 y: np.ndarray) -> np.ndarray:
    return np.where(leaf_w > 0, leaf_V[..., 0] / np.maximum(leaf_w, 1e-12),
                    float(y.mean())).astype(np.float32)


@register_stage
class DecisionTreeRegressor(_TreeParams):
    """Single variance-reduction tree; leaf = mean target."""

    is_classifier = False

    def fit(self, frame: Frame) -> "TreeRegressorModel":
        y, edges, Xb = self._prep(frame)
        y = y.astype(np.float32)
        n, F = Xb.shape
        (feats, bins, leaf_V, leaf_w), on = self._grow(
            Xb, y[:, None], np.ones((1, n), np.float32),
            np.ones((1, F), bool))
        model = TreeRegressorModel(featuresCol=self.featuresCol,
                                   labelCol=self.labelCol)
        model._state = {
            "feats": feats, "thrs": _thresholds(feats, bins, edges),
            "values": _leaf_values(leaf_V, leaf_w, y),
            "depth": self.maxDepth, "base": 0.0, "scale": 1.0}
        model.fit_device = on
        return model


@register_stage
class RandomForestRegressor(_TreeParams):
    is_classifier = False
    numTrees = IntParam("numTrees", "number of trees", 20,
                        validator=lambda v: v >= 1)
    featureSubsetStrategy = StringParam(
        "featureSubsetStrategy", "features considered per tree",
        "auto", domain=["auto", "all", "sqrt", "log2", "onethird"])
    subsamplingRate = FloatParam("subsamplingRate", "bootstrap sample rate", 1.0)
    seed = IntParam("seed", "random seed", 0)

    def fit(self, frame: Frame) -> "TreeRegressorModel":
        y, edges, Xb = self._prep(frame)
        y = y.astype(np.float32)
        n, F = Xb.shape
        T = self.numTrees
        rng = np.random.default_rng(self.seed)
        draws = max(1, int(round(n * self.subsamplingRate)))
        weights = rng.multinomial(
            draws, np.full(n, 1.0 / n), size=T).astype(np.float32)
        masks = _feature_masks(F, T, self.featureSubsetStrategy, False, rng)
        (feats, bins, leaf_V, leaf_w), on = self._grow(
            Xb, y[:, None], weights, masks)
        model = TreeRegressorModel(featuresCol=self.featuresCol,
                                   labelCol=self.labelCol)
        model._state = {"feats": feats,
                        "thrs": _thresholds(feats, bins, edges),
                        "values": _leaf_values(leaf_V, leaf_w, y),
                        "depth": self.maxDepth, "base": 0.0,
                        "scale": 1.0 / T}
        model.fit_device = on
        return model


@register_stage
class TreeRegressorModel(_TreeScorer, HasFeaturesCol, HasLabelCol, Model):
    """prediction = base + scale * sum_t leaf_value_t(x); scale=1/T gives a
    forest mean, scale=learning-rate gives a boosted ensemble."""

    def predict_fn(self):
        device = resolve_device()
        feats, thrs, depth = self._trees(device)
        values = _on_device(self._state["values"], device)      # (T, 2^D)
        base = float(self._state["base"])
        scale = float(self._state["scale"])

        @torch.inference_mode()
        def f(X):
            leaves = predict_leaves_trees(X, feats, thrs, depth)
            return base + scale * torch.gather(values, 1, leaves).sum(dim=0)
        return f

    def transform(self, frame: Frame) -> Frame:
        return _score_regressor(self, frame)


# --------------------------------------------------------------------------
# gradient boosting
class _GBTBase(_TreeParams):
    maxIter = IntParam("maxIter", "boosting rounds", 20,
                       validator=lambda v: v >= 1)
    stepSize = FloatParam("stepSize", "shrinkage (learning rate)", 0.1)

    def _boost(self, Xb: np.ndarray, edges: np.ndarray, grad_fn,
               F0: np.ndarray, device: torch.device
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, str]:
        """Generic Newton boosting loop. grad_fn(F) -> (g, h); the round's
        tree fits -g/h via the gradient gain and its training-set leaf
        assignment (from grow_trees) updates F without a re-walk. The
        rounds' trees stay on the device and come home in one fetch."""
        n, F_feats = Xb.shape
        depth, B = self.maxDepth, self.maxBins
        lam = max(self.lam, 1e-6)
        Xb_d = _device_bins(Xb, device)
        ones_mask = torch.ones((1, F_feats), dtype=torch.bool, device=device)
        min_w = float(self.minInstancesPerNode)
        Fcur = _on_device(F0, device)
        all_feats, all_bins, all_values = [], [], []
        for _ in range(self.maxIter):
            g, h = grad_fn(Fcur)
            feats, bins, leaf_V, leaf_w, node = grow_trees(
                Xb_d, (-g)[None, :, None], h[None], ones_mask, depth, B,
                lam, min_w, counts=torch.ones_like(h)[None])
            # Newton leaf: sum(-g)/(sum(h)+lam)
            value = leaf_V[0, :, 0] / (leaf_w[0] + lam)
            Fcur = Fcur + self.stepSize * value[node[0]]
            all_feats.append(feats[0])
            all_bins.append(bins[0])
            all_values.append(value)
        feats, bins, values = obssyncs.device_get(
            (torch.stack(all_feats), torch.stack(all_bins),
             torch.stack(all_values)), "learner.trees")
        return (feats, _thresholds(feats, bins, edges),
                values.astype(np.float32), str(Xb_d.device))


@register_stage
class GBTClassifier(_GBTBase):
    """Binary gradient-boosted trees on logistic loss (Spark GBTClassifier
    is binary-only, ``TrainClassifier.scala:108-116``)."""

    def fit(self, frame: Frame) -> "GBTClassifierModel":
        y, edges, Xb = self._prep(frame)
        y = y.astype(np.int32)
        K = self._num_classes(frame, y)
        if K > 2:
            raise ValueError("GBTClassifier supports binary labels only "
                             "(parity with Spark GBTClassifier)")
        device = resolve_device()
        yf = _on_device(y, device)
        p0 = float(np.clip(y.mean(), 1e-6, 1 - 1e-6))
        F0 = np.full(len(y), np.log(p0 / (1 - p0)), np.float32)

        def grad_fn(Fcur):
            p = torch.sigmoid(Fcur)
            return p - yf, p * (1 - p)

        feats, thrs, values, on = self._boost(Xb, edges, grad_fn, F0, device)
        model = GBTClassifierModel(featuresCol=self.featuresCol,
                                   labelCol=self.labelCol)
        model._state = {"feats": feats, "thrs": thrs, "values": values,
                        "depth": self.maxDepth, "base": float(F0[0]),
                        "scale": self.stepSize, "n_classes": 2}
        model.fit_device = on
        return model


@register_stage
class GBTClassifierModel(_TreeScorer, HasFeaturesCol, HasLabelCol, Model):
    def scores_fn(self):
        device = resolve_device()
        feats, thrs, depth = self._trees(device)
        values = _on_device(self._state["values"], device)
        base = float(self._state["base"])
        scale = float(self._state["scale"])

        @torch.inference_mode()
        def f(X):
            leaves = predict_leaves_trees(X, feats, thrs, depth)
            margin = base + scale * torch.gather(values, 1, leaves).sum(dim=0)
            p1 = torch.sigmoid(margin)
            probs = torch.stack([1 - p1, p1], dim=1)
            logits = torch.stack([-margin / 2, margin / 2], dim=1)
            return logits, probs
        return f

    def transform(self, frame: Frame) -> Frame:
        return _score_classifier(self, frame)


@register_stage
class GBTRegressor(_GBTBase):
    """Gradient-boosted trees on squared loss."""

    is_classifier = False

    def fit(self, frame: Frame) -> "TreeRegressorModel":
        y, edges, Xb = self._prep(frame)
        y = y.astype(np.float32)
        device = resolve_device()
        yd = _on_device(y, device)
        F0 = np.full(len(y), float(y.mean()), np.float32)

        def grad_fn(Fcur):
            return Fcur - yd, torch.ones_like(Fcur)

        feats, thrs, values, on = self._boost(Xb, edges, grad_fn, F0, device)
        model = TreeRegressorModel(featuresCol=self.featuresCol,
                                   labelCol=self.labelCol)
        model._state = {"feats": feats, "thrs": thrs, "values": values,
                        "depth": self.maxDepth, "base": float(F0[0]),
                        "scale": self.stepSize}
        model.fit_device = on
        return model
