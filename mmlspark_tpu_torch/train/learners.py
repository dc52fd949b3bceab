"""The built-in learners and the scaffolding they share with the deep ones.

The port of ``mmlspark_tpu/train/learners.py``: featurize hints, the
streaming-statistics base class (``JaxEstimator`` there,
:class:`TorchEstimator` here), the pad-and-mask batch maker, the
resident epoch cache constructor, the minibatch optimizer loop
(:func:`_stream_adam`), the scoring helpers of fitted models, and the
learners TrainClassifier / TrainRegressor take: ``LogisticRegression``,
``MLPClassifier``, ``NaiveBayes``, ``LinearRegression`` and
``MLPRegressor``. Tree learners live in ``train/trees.py``.

Every fit and every score runs on ``runtime.device`` (``resolve_device``).
Every fit keeps one batch shape: the tail batch is zero-padded and masked
out of the loss by a per-row weight, the reference's pad-and-drop
workaround (``CNTKModel.scala:71-76``). A fit's optimizer loop is eager
torch: forward, ``backward()``, the optimizer step, then the proximal
step; it reads nothing back from the device until the fitted parameters
come home in one counted fetch. The learners fit on one device: inside a
``torch.distributed`` group each rank fits the frame it was given on its
own ``runtime.device``, as the reference's learners fit each process's
frame on its first local device.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.core.params import (
    FloatParam, HasFeaturesCol, HasLabelCol, IntParam, ListParam,
)
from mmlspark_tpu_torch.core.pipeline import Estimator, Model
from mmlspark_tpu_torch.core.schema import ColumnSchema, DType
from mmlspark_tpu_torch.core.serialization import register_stage
from mmlspark_tpu_torch.observability import syncs as obssyncs
from mmlspark_tpu_torch.parallel import optim
from mmlspark_tpu_torch.utils.config import resolve_device


class FeaturizeHints:
    """How TrainClassifier should featurize for a learner (reference
    ``getFeaturizeParams``, ``TrainClassifier.scala:170-185``)."""

    def __init__(self, one_hot: bool = True, num_features: int = 1 << 18):
        self.one_hot = one_hot
        self.num_features = num_features


class HasBatchSize:
    """Mixin for learners that stream minibatches."""
    batchSize = IntParam("batchSize", "minibatch rows per optimizer step",
                         8192, validator=lambda v: v > 0)


class TorchEstimator(HasFeaturesCol, HasLabelCol, Estimator):
    """Base for the port's learners: streaming statistics over the
    (features, label) columns, in numpy on the host."""

    hints = FeaturizeHints()
    is_classifier = True

    def _peek_dim(self, frame: Frame) -> int:
        """Feature-vector width from the first row only (no data scan)."""
        for hb in frame.batches(1, cols=[self.featuresCol]):
            x = np.asarray(hb[self.featuresCol])
            if x.ndim != 2:
                raise ValueError(f"features column {self.featuresCol!r} must "
                                 "be a vector column")
            return x.shape[1]
        raise ValueError(f"{type(self).__name__}: empty frame")

    def _label_max(self, frame: Frame) -> int:
        """Max label value, streaming the label column only."""
        ymax = -1
        for hb in frame.batches(1 << 18, cols=[self.labelCol]):
            y = np.asarray(hb[self.labelCol])
            if len(y):
                ymax = max(ymax, int(y.max()))
        if ymax < 0:
            raise ValueError(f"{type(self).__name__}: empty frame")
        return ymax

    def _streaming_moments(self, frame: Frame):
        """One streaming pass over (features, label): the raw accumulators
        ``(n, d, s, ss, ymax, ysum, ysumsq)``."""
        fcol, lcol = self.featuresCol, self.labelCol
        bs = self.get("batchSize") if any(
            p.name == "batchSize" for p in self.params()) else 1 << 16
        n, d = 0, None
        s = ss = None
        ymax, ysum, ysumsq = -1, 0.0, 0.0
        for hb in frame.batches(bs, cols=[fcol, lcol]):
            x = np.asarray(hb[fcol], dtype=np.float64)
            if x.ndim != 2:
                raise ValueError(
                    f"features column {fcol!r} must be a vector column")
            if d is None:
                d = x.shape[1]
                s, ss = np.zeros(d), np.zeros(d)
            n += x.shape[0]
            s += x.sum(axis=0)
            ss += (x * x).sum(axis=0)
            y = np.asarray(hb[lcol], dtype=np.float64)
            if len(y):
                ymax = max(ymax, int(y.max()))
                ysum += y.sum()
                ysumsq += (y * y).sum()
        return n, d, s, ss, ymax, ysum, ysumsq

    @staticmethod
    def _finalize_stats(n, d, s, ss, ymax, ysum, ysumsq):
        """Moments -> (n, d, mu, sigma, ymax, ymu, ysigma)."""
        if n == 0:
            raise ValueError("empty frame")
        mu = (s / n).astype(np.float32)
        sigma = (np.sqrt(np.maximum(ss / n - (s / n) ** 2, 0.0)) + 1e-6
                 ).astype(np.float32)
        ymu = ysum / n
        ysigma = float(np.sqrt(max(ysumsq / n - ymu * ymu, 0.0))) + 1e-6
        return n, d, mu, sigma, max(int(ymax), 0), float(ymu), ysigma

    def _streaming_stats(self, frame: Frame):
        """One streaming pass over (features, label):
        (n, d, mu, sigma, ymax, ymu, ysigma)."""
        moments = self._streaming_moments(frame)
        if moments[0] == 0:
            raise ValueError(f"{type(self).__name__}: empty frame")
        return self._finalize_stats(*moments)

    def _num_classes(self, frame: Frame, y) -> int:
        """Class count from the label column's level metadata when present
        (max(y) alone under-counts when a class's rows were dropped); ``y``
        is the max label or a label array."""
        if isinstance(y, np.ndarray):
            y = int(y.max()) if len(y) else 1
        seen = int(y) + 1
        cmap = frame.schema[self.labelCol].categorical
        if cmap is not None:
            seen = max(seen, cmap.num_levels)
        return max(seen, 2)


def _pad_xyw(hb: Dict[str, np.ndarray], fcol: str, lcol: str, bs: int,
             y_dtype) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fixed-shape (x, y, w) batch: zero-pad the tail, mask it via w."""
    x = np.asarray(hb[fcol], dtype=np.float32)
    y = np.asarray(hb[lcol]).astype(y_dtype)
    k = x.shape[0]
    w = np.ones((bs,), np.float32)
    if k < bs:
        x = np.concatenate([x, np.zeros((bs - k,) + x.shape[1:], x.dtype)])
        y = np.concatenate([y, np.zeros((bs - k,), y.dtype)])
        w[k:] = 0.0
    return x, y, w


def _epoch_device_cache(frame: Frame, fcol: str, lcol: str, batch_size: int,
                        y_dtype, device=None, seed: int = 0,
                        force: bool = False, mesh=None,
                        local_batch: Optional[int] = None,
                        steps: Optional[int] = None):
    """Pad-and-masked epoch -> shuffled ``DeviceEpochCache``, or None when
    it exceeds ``runtime.device_cache_mb`` (unless ``force``).

    The budget check runs on shape/dtype stand-ins, so an over-budget
    frame costs no host materialization; the tail rows are padded once
    with zero weight and ride through every shuffled epoch masked out of
    the loss. A single-batch epoch skips the shuffle: batch composition
    does not change under a permutation. On a ``mesh`` without
    ``local_batch`` the frame is the global epoch and each rank uploads
    its block of every batch.

    Multi-process (``local_batch`` / ``steps`` given, on a mesh): the
    frame is this rank's shard, ``batch_size`` stays the GLOBAL batch and
    the shard pads to its quota of ``steps * local_batch`` rows; the
    cache is the local-rows form (``DeviceEpochCache(local=True)``). The
    verdict is the group's: each rank budgets its own padded shard, and
    the verdicts are AND-reduced over the mesh's ranks, so no rank takes
    the cached path while another streams (mismatched collectives, or
    different epoch orders). A rank with an empty shard makes every rank
    stream (``'on'`` raises on every rank).
    """
    from mmlspark_tpu_torch.parallel.trainer import DeviceEpochCache
    local = mesh is not None and local_batch is not None
    local_batch = batch_size if local_batch is None else local_batch
    n = frame.count()
    if n == 0 and not local:
        raise ValueError("empty frame")
    steps = int(np.ceil(n / local_batch)) if steps is None else steps
    padded = steps * local_batch
    if n > padded:
        raise ValueError(
            f"shard of {n} rows exceeds its epoch quota {padded} "
            f"({steps} steps x {local_batch} local rows)")
    shuffle = steps > 1
    fits = force
    if n and not force:
        d = np.asarray(frame.head(1)[0][fcol]).size
        fits = DeviceEpochCache.fits({
            "x": np.broadcast_to(np.float32(0), (padded, d)),
            "y": np.broadcast_to(np.zeros((), y_dtype), (padded,)),
            "w": np.broadcast_to(np.float32(0), (padded,))},
            shuffle=shuffle)
    if local:
        from mmlspark_tpu_torch.parallel.collectives import host_all_gather
        verdicts = host_all_gather((n > 0, fits), _mesh_group(mesh))
        if not all(has_rows for has_rows, _ in verdicts):
            # a rank with an empty shard streams zero-weight filler; the
            # cache needs rows on every rank
            if force:
                raise ValueError("a resident epoch needs rows on every "
                                 "rank; some rank's shard is empty")
            return None
        fits = all(ok for _, ok in verdicts)
    if not fits:
        return None
    x = np.asarray(frame.column(fcol), np.float32)
    y = np.asarray(frame.column(lcol))
    epoch = dict(zip(("x", "y", "w"),
                     _pad_xyw({fcol: x, lcol: y}, fcol, lcol, padded,
                              y_dtype)))
    return DeviceEpochCache(epoch, batch_size, mesh=mesh, shuffle=shuffle,
                            seed=seed, device=device, local=local)


def _mesh_group(mesh):
    """The process group of every rank of ``mesh`` (None for one rank)."""
    from mmlspark_tpu_torch.parallel.mesh import AXES
    from mmlspark_tpu_torch.parallel.sharding import axis_group
    return axis_group(mesh, AXES)


def _leaves(tree) -> list:
    """The tensors of a dict / list tree, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in tree for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _on_device(a, device: torch.device) -> torch.Tensor:
    """A host float array as a float32 tensor on ``device``."""
    return torch.from_numpy(np.require(a, np.float32, ["C", "W"])).to(device)


def _stream_adam(loss_fn: Callable, params: Any, frame: Frame,
                 fcol: str, lcol: str, *, lr: float, max_steps: int,
                 batch_size: int, y_dtype=np.int64, seed: int = 0,
                 prox: Optional[Callable] = None,
                 opt: Optional[optim.Optimizer] = None,
                 device: Optional[torch.device] = None) -> Tuple[Any, str]:
    """Minibatch Adam streamed from the frame: one batch shape, epochs
    cycled until ``max_steps`` optimizer steps have run.

    ``params`` is a dict / list tree of host arrays; ``loss_fn(params, x,
    y, w)`` a per-row-weighted loss over the tree of device tensors;
    ``prox(params)``, when given, updates the tree in place after each
    optimizer step (the L1 soft-threshold of elastic-net LR).

    Epoch residency: when the pad-and-masked epoch fits the
    ``runtime.device_cache_mb`` budget (the common case for tabular
    learners), it is uploaded ONCE (``DeviceEpochCache``) and each epoch is
    a device-side permutation of it; a larger frame streams shuffled host
    batches instead. Returns the fitted tree as host arrays, fetched in one
    counted sync, and the device the batches lay on."""
    device = resolve_device() if device is None else device
    params = _tree_map(lambda a: _on_device(a, device).requires_grad_(),
                       params)
    state = (optim.adam(lr) if opt is None else opt).init(_leaves(params))
    batch_device = None

    def step(x, y, w):
        nonlocal batch_device
        batch_device = str(x.device)
        state.zero_grad()
        loss_fn(params, x, y, w).backward()
        state.step()
        if prox is not None:
            with torch.no_grad():
                prox(params)

    cache = _epoch_device_cache(frame, fcol, lcol, batch_size, y_dtype,
                                device=device, seed=seed)
    steps = 0
    if cache is not None:
        epoch_i = 0
        while steps < max_steps:
            for b in cache.batches(epoch_i):
                step(b["x"], b["y"], b["w"])
                steps += 1
                if steps >= max_steps:
                    break
            epoch_i += 1
    else:
        from mmlspark_tpu_torch.parallel.trainer import to_device
        host_rng = np.random.default_rng(seed)
        while steps < max_steps:
            for hb in frame.shuffled_batches(batch_size, cols=[fcol, lcol],
                                             rng=host_rng):
                step(*(to_device(a, device) for a in
                       _pad_xyw(hb, fcol, lcol, batch_size, y_dtype)))
                steps += 1
                if steps >= max_steps:
                    break
    return obssyncs.device_get(params, "learner.params"), batch_device


def _weighted_mean(per_row: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (per_row * w).sum() / torch.clamp(w.sum(), min=1.0)


def _mlp_forward(layers, h: torch.Tensor) -> torch.Tensor:
    for layer in layers[:-1]:
        h = torch.relu(h @ layer["w"] + layer["b"])
    return h @ layers[-1]["w"] + layers[-1]["b"]


def _mlp_init(sizes, seed: int):
    """He-normal weights and zero biases from a seeded ``torch.Generator``
    (the JAX package draws from ``jax.random``: same law, other numbers)."""
    gen = torch.Generator().manual_seed(int(seed))
    return [{"w": (torch.randn(sizes[i], sizes[i + 1], generator=gen)  # lint: allow-sync (host init draw)
                   * float(np.sqrt(2.0 / sizes[i]))).numpy(),
             "b": np.zeros((sizes[i + 1],), np.float32)}
            for i in range(len(sizes) - 1)]


# --------------------------------------------------------------------------
@register_stage
class LogisticRegression(HasBatchSize, TorchEstimator):
    """Multinomial logistic regression trained by streamed minibatch Adam.

    Epochs are shuffled, every step has one batch shape, and the Spark
    elastic-net objective applies to the weights
    (``regParam * (elasticNetParam*||w||_1 + (1-elasticNetParam)/2*||w||_2^2)``,
    intercept unregularized, features standardized — the objective Spark
    ML's LogisticRegression minimizes). The L1 part runs as a proximal
    soft-threshold after each step. ``maxIter`` counts minibatch optimizer
    steps, not full-dataset passes."""

    maxIter = IntParam("maxIter", "number of minibatch optimizer steps", 200)
    regParam = FloatParam("regParam", "regularization strength", 1e-4)
    elasticNetParam = FloatParam(
        "elasticNetParam", "L1 ratio in [0,1]: 0 = pure L2, 1 = pure L1",
        0.0, validator=lambda v: 0.0 <= v <= 1.0)
    learningRate = FloatParam("learningRate", "Adam learning rate", 0.1)

    def fit(self, frame: Frame) -> "LinearClassifierModel":
        n, d, mu, sigma, ymax, _, _ = self._streaming_stats(frame)
        n_classes = self._num_classes(frame, ymax)
        device = resolve_device()
        params = {"w": np.zeros((d, n_classes), np.float32),
                  "b": np.zeros((n_classes,), np.float32)}
        alpha = float(self.elasticNetParam)
        l1 = float(self.regParam) * alpha
        l2 = float(self.regParam) * (1.0 - alpha) / 2.0
        mu_d, sigma_d = _on_device(mu, device), _on_device(sigma, device)

        def loss(p, X, y, w):
            logits = ((X - mu_d) / sigma_d) @ p["w"] + p["b"]
            ce = F.cross_entropy(logits, y, reduction="none")
            return _weighted_mean(ce, w) + l2 * (p["w"] ** 2).sum()

        prox = opt = None
        if l1 > 0:
            # proximal SGD, not Adam: the soft-threshold lr*l1 only matches
            # the smooth step when the step is lr*gradient — under Adam's
            # per-coordinate normalization L1 cannot zero weak features
            sgd_lr = float(self.learningRate)
            opt = optim.sgd(sgd_lr)
            shrink = sgd_lr * l1

            def prox(p):
                w = p["w"]
                w.copy_(torch.sign(w) * torch.clamp(w.abs() - shrink, min=0.0))

        params, on = _stream_adam(loss, params, frame, self.featuresCol,
                                  self.labelCol, lr=self.learningRate,
                                  max_steps=self.maxIter,
                                  batch_size=self.batchSize, prox=prox,
                                  opt=opt, device=device)
        model = LinearClassifierModel(featuresCol=self.featuresCol,
                                      labelCol=self.labelCol)
        model._state = {"w": params["w"], "b": params["b"],
                        "mu": mu, "sigma": sigma, "n_classes": n_classes}
        model.fit_device = on
        return model


@register_stage
class LinearClassifierModel(HasFeaturesCol, HasLabelCol, Model):
    def scores_fn(self):
        device = resolve_device()
        w, b, mu, sigma = (_on_device(self._state[k], device)
                           for k in ("w", "b", "mu", "sigma"))

        @torch.inference_mode()
        def f(X):
            logits = ((X - mu) / sigma) @ w + b
            return logits, torch.softmax(logits, dim=-1)
        return f

    def transform(self, frame: Frame) -> Frame:
        return _score_classifier(self, frame)


# --------------------------------------------------------------------------
@register_stage
class MLPClassifier(HasBatchSize, TorchEstimator):
    """Multi-layer perceptron classifier (ReLU hidden layers, softmax head)."""

    hints = FeaturizeHints(one_hot=True, num_features=1 << 12)

    layers = ListParam("layers", "hidden layer sizes", [128])
    maxIter = IntParam("maxIter", "number of optimizer steps", 300)
    learningRate = FloatParam("learningRate", "Adam learning rate", 1e-2)
    seed = IntParam("seed", "PRNG seed", 0)

    def _init_params(self, sizes, seed: int):
        """Initial ``[{"w", "b"}, ...]`` host arrays of a ``sizes`` MLP."""
        return _mlp_init(sizes, seed)

    def fit(self, frame: Frame) -> "MLPClassifierModel":
        n, d, mu, sigma, ymax, _, _ = self._streaming_stats(frame)
        n_classes = self._num_classes(frame, ymax)
        sizes = [d] + [int(h) for h in self.layers] + [n_classes]
        device = resolve_device()
        mu_d, sigma_d = _on_device(mu, device), _on_device(sigma, device)

        def loss(p, X, y, w):
            logits = _mlp_forward(p, (X - mu_d) / sigma_d)
            return _weighted_mean(
                F.cross_entropy(logits, y, reduction="none"), w)

        params, on = _stream_adam(loss, self._init_params(sizes, self.seed),
                                  frame, self.featuresCol, self.labelCol,
                                  lr=self.learningRate,
                                  max_steps=self.maxIter,
                                  batch_size=self.batchSize, device=device)
        model = MLPClassifierModel(featuresCol=self.featuresCol,
                                   labelCol=self.labelCol)
        model._state = {"layers": params, "mu": mu, "sigma": sigma,
                        "n_classes": n_classes}
        model.fit_device = on
        return model


@register_stage
class MLPClassifierModel(HasFeaturesCol, HasLabelCol, Model):
    def scores_fn(self):
        device = resolve_device()
        layers = _tree_map(lambda a: _on_device(a, device),
                           self._state["layers"])
        mu = _on_device(self._state["mu"], device)
        sigma = _on_device(self._state["sigma"], device)

        @torch.inference_mode()
        def f(X):
            logits = _mlp_forward(layers, (X - mu) / sigma)
            return logits, torch.softmax(logits, dim=-1)
        return f

    def transform(self, frame: Frame) -> Frame:
        return _score_classifier(self, frame)


# --------------------------------------------------------------------------
@register_stage
class NaiveBayes(HasBatchSize, TorchEstimator):
    """Multinomial naive Bayes via one batched count matmul (non-negative
    features, e.g. hashed term counts / one-hots)."""

    hints = FeaturizeHints(one_hot=True, num_features=1 << 18)
    smoothing = FloatParam("smoothing", "Laplace smoothing", 1.0)

    def fit(self, frame: Frame) -> "NaiveBayesModel":
        # d from the first row; class count from the observed label max AND
        # the label metadata (metadata alone can under-count when it was
        # fit elsewhere)
        from mmlspark_tpu_torch.parallel.trainer import to_device
        d = self._peek_dim(frame)
        ymax = self._label_max(frame)
        n_classes = self._num_classes(frame, ymax)
        bs = self.batchSize
        device = resolve_device()
        counts = torch.zeros((n_classes, d), dtype=torch.float32,
                             device=device)
        prior = torch.zeros((n_classes,), dtype=torch.float32, device=device)
        for hb in frame.batches(bs, cols=[self.featuresCol, self.labelCol]):
            x, y, w = (to_device(a, device) for a in _pad_xyw(
                hb, self.featuresCol, self.labelCol, bs, np.int64))
            onehot = F.one_hot(y, n_classes).float() * w[:, None]   # (b, C)
            counts += onehot.T @ torch.clamp(x, min=0.0)
            prior += onehot.sum(dim=0)
        log_prior = torch.log((prior + 1.0) / (prior.sum() + n_classes))
        smoothed = counts + self.smoothing
        log_cond = torch.log(smoothed / smoothed.sum(dim=1, keepdim=True))
        host = obssyncs.device_get({"log_prior": log_prior,
                                    "log_cond": log_cond}, "learner.params")
        model = NaiveBayesModel(featuresCol=self.featuresCol,
                                labelCol=self.labelCol)
        model._state = {**host, "n_classes": n_classes}
        model.fit_device = str(counts.device)
        return model


@register_stage
class NaiveBayesModel(HasFeaturesCol, HasLabelCol, Model):
    def scores_fn(self):
        device = resolve_device()
        log_prior = _on_device(self._state["log_prior"], device)
        log_cond = _on_device(self._state["log_cond"], device)

        @torch.inference_mode()
        def f(X):
            logits = torch.clamp(X, min=0.0) @ log_cond.T + log_prior
            return logits, torch.softmax(logits, dim=-1)
        return f

    def transform(self, frame: Frame) -> Frame:
        return _score_classifier(self, frame)


# --------------------------------------------------------------------------
@register_stage
class LinearRegression(HasBatchSize, TorchEstimator):
    """Ridge regression by closed-form normal equations (exact, one solve)."""

    is_classifier = False
    regParam = FloatParam("regParam", "L2 regularization strength", 1e-6)

    def fit(self, frame: Frame) -> "LinearRegressionModel":
        from mmlspark_tpu_torch.parallel.trainer import to_device
        d = self._peek_dim(frame)
        bs = self.batchSize
        device = resolve_device()
        # Streaming normal equations: accumulate the (d+1)x(d+1) Gram
        # matrix and moment vector per batch on the device
        A = torch.zeros((d + 1, d + 1), dtype=torch.float32, device=device)
        by = torch.zeros((d + 1,), dtype=torch.float32, device=device)
        for hb in frame.batches(bs, cols=[self.featuresCol, self.labelCol]):
            x, y, w = (to_device(a, device) for a in _pad_xyw(
                hb, self.featuresCol, self.labelCol, bs, np.float32))
            Xb = torch.cat([x, torch.ones((x.shape[0], 1), dtype=x.dtype,
                                          device=device)], dim=1)
            A += (Xb * w[:, None]).T @ Xb
            by += Xb.T @ (y * w)
        eye = torch.eye(d + 1, dtype=A.dtype, device=device)
        wb = obssyncs.device_get(
            torch.linalg.solve(A + self.regParam * eye, by), "learner.params")
        model = LinearRegressionModel(featuresCol=self.featuresCol,
                                      labelCol=self.labelCol)
        model._state = {"w": wb[:-1], "b": float(wb[-1])}
        model.fit_device = str(A.device)
        return model


@register_stage
class LinearRegressionModel(HasFeaturesCol, HasLabelCol, Model):
    def predict_fn(self):
        w = _on_device(self._state["w"], resolve_device())
        b = float(self._state["b"])

        @torch.inference_mode()
        def f(X):
            return X @ w + b
        return f

    def transform(self, frame: Frame) -> Frame:
        return _score_regressor(self, frame)


@register_stage
class MLPRegressor(HasBatchSize, TorchEstimator):
    is_classifier = False
    hints = FeaturizeHints(one_hot=True, num_features=1 << 12)

    layers = ListParam("layers", "hidden layer sizes", [128])
    maxIter = IntParam("maxIter", "number of optimizer steps", 300)
    learningRate = FloatParam("learningRate", "Adam learning rate", 1e-2)
    seed = IntParam("seed", "PRNG seed", 0)

    def _init_params(self, sizes, seed: int):
        """Initial ``[{"w", "b"}, ...]`` host arrays of a ``sizes`` MLP."""
        return _mlp_init(sizes, seed)

    def fit(self, frame: Frame) -> "MLPRegressorModel":
        n, d, mu, sigma, _, ymu, ysigma = self._streaming_stats(frame)
        sizes = [d] + [int(h) for h in self.layers] + [1]
        device = resolve_device()
        mu_d, sigma_d = _on_device(mu, device), _on_device(sigma, device)

        def loss(p, X, y, w):
            pred = _mlp_forward(p, (X - mu_d) / sigma_d)[:, 0]
            return _weighted_mean((pred - (y - ymu) / ysigma) ** 2, w)

        params, on = _stream_adam(loss, self._init_params(sizes, self.seed),
                                  frame, self.featuresCol, self.labelCol,
                                  lr=self.learningRate,
                                  max_steps=self.maxIter,
                                  batch_size=self.batchSize,
                                  y_dtype=np.float32, device=device)
        model = MLPRegressorModel(featuresCol=self.featuresCol,
                                  labelCol=self.labelCol)
        model._state = {"layers": params, "mu": mu, "sigma": sigma,
                        "ymu": ymu, "ysigma": ysigma}
        model.fit_device = on
        return model


@register_stage
class MLPRegressorModel(HasFeaturesCol, HasLabelCol, Model):
    def predict_fn(self):
        device = resolve_device()
        layers = _tree_map(lambda a: _on_device(a, device),
                           self._state["layers"])
        mu = _on_device(self._state["mu"], device)
        sigma = _on_device(self._state["sigma"], device)
        ymu, ysigma = float(self._state["ymu"]), float(self._state["ysigma"])

        @torch.inference_mode()
        def f(X):
            return _mlp_forward(layers, (X - mu) / sigma)[:, 0] * ysigma + ymu
        return f

    def transform(self, frame: Frame) -> Frame:
        return _score_regressor(self, frame)


# --------------------------------------------------------------------------
# scoring helpers shared by the fitted models

def _pad_rows(x: np.ndarray, bs: int) -> np.ndarray:
    """Zero-pad a partial batch up to ``bs`` rows (sliced off after
    scoring)."""
    k = x.shape[0]
    if k == bs:
        return x
    return np.concatenate([x, np.zeros((bs - k,) + x.shape[1:], x.dtype)])


def _device_feature_batches(model, frame: Frame, bs: int,
                            device: torch.device):
    """Iterate (device batch, valid rows) for scoring. The padded feature
    batches go through the residency registry, so re-scoring the same
    frame transfers its features once; an over-budget frame copies a batch
    at a time."""
    from mmlspark_tpu_torch.models import residency
    from mmlspark_tpu_torch.parallel.trainer import to_device
    n_rows = frame.count()

    def build() -> np.ndarray:
        return np.stack([
            _pad_rows(np.asarray(b[model.featuresCol], np.float32), bs)
            for b in frame.batches(bs, cols=[model.featuresCol])])

    dev = None
    if n_rows:
        d = np.asarray(frame.head(1)[0][model.featuresCol]).size
        steps = int(np.ceil(n_rows / bs))
        dev = residency.resident_batches(
            frame, (model.featuresCol, bs, "learner-f32"), build, device,
            nbytes_hint=steps * bs * d * 4)
    if dev is not None:
        for i in range(dev.shape[0]):
            yield dev[i], min(bs, n_rows - i * bs)
        return
    for batch in frame.batches(bs, cols=[model.featuresCol]):
        x = np.asarray(batch[model.featuresCol], dtype=np.float32)
        yield to_device(_pad_rows(x, bs), device), x.shape[0]


def _scored(model, frame: Frame, fn, batch_size: int, site: str):
    """Run ``fn(device batch) -> (B, k) tensor`` over the frame; the
    outputs stay on the device and come back in ONE counted fetch."""
    device = resolve_device()
    n_rows = frame.count()
    bs = min(batch_size, max(n_rows, 1))
    outs = [fn(x)[:k] for x, k in
            _device_feature_batches(model, frame, bs, device)]
    if not outs:
        return None
    return obssyncs.device_get(torch.cat(outs), site)


def _score_classifier(model, frame: Frame, batch_size: int = 65536) -> Frame:
    """Append ``prediction`` / ``rawPrediction`` / ``probability`` columns.

    Minibatches stream to the device (the reference's buffered minibatch
    iterator, ``CNTKModel.scala:50-104``); the tail batch is padded to the
    batch shape and sliced after."""
    f = model._cached_build(model.scores_fn, key=str(resolve_device()))

    def packed(x):
        logits, p = f(x)
        pred = torch.argmax(logits, dim=-1, keepdim=True).to(logits.dtype)
        return torch.cat([pred, logits, p], dim=1)

    host = _scored(model, frame, packed, batch_size, "score.fetch")
    if host is None:
        pred = np.zeros(0, np.int64)
        scores = probs = np.zeros((0, 2), np.float32)
    else:
        k = (host.shape[1] - 1) // 2
        pred = host[:, 0]
        scores, probs = host[:, 1:1 + k], host[:, 1 + k:]
    out = frame.with_column_values(
        ColumnSchema("prediction", DType.FLOAT64), pred.astype(np.float64))
    out = out.with_column_values(
        ColumnSchema("rawPrediction", DType.VECTOR),
        np.ascontiguousarray(scores, np.float32))
    return out.with_column_values(
        ColumnSchema("probability", DType.VECTOR),
        np.ascontiguousarray(probs, np.float32))


def _score_regressor(model, frame: Frame, batch_size: int = 65536) -> Frame:
    f = model._cached_build(model.predict_fn, key=str(resolve_device()))
    host = _scored(model, frame, lambda x: f(x)[:, None], batch_size,
                   "score.fetch")
    pred = np.zeros(0, np.float64) if host is None else host[:, 0]
    return frame.with_column_values(
        ColumnSchema("prediction", DType.FLOAT64), pred.astype(np.float64))
