"""Learner scaffolding shared by the deep Estimators.

The part of ``mmlspark_tpu/train/learners.py`` that ``train/deep.py``
needs: featurize hints, the streaming-statistics base class
(``JaxEstimator`` there, :class:`TorchEstimator` here), the pad-and-mask
batch builder, the resident epoch cache constructor, and the scoring
helpers of fitted models. The linear, naive-Bayes and MLP learners come
with the tabular slice (ROADMAP slice 3).

Every fit keeps one batch shape: the tail batch is zero-padded and masked
out of the loss by a per-row weight, the reference's pad-and-drop
workaround (``CNTKModel.scala:71-76``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.core.params import HasFeaturesCol, HasLabelCol, IntParam
from mmlspark_tpu_torch.core.pipeline import Estimator
from mmlspark_tpu_torch.core.schema import ColumnSchema, DType
from mmlspark_tpu_torch.observability import syncs as obssyncs
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
                        force: bool = False):
    """Pad-and-masked epoch -> shuffled ``DeviceEpochCache``, or None when
    it exceeds ``runtime.device_cache_mb`` (unless ``force``).

    The budget check runs on shape/dtype stand-ins, so an over-budget
    frame costs no host materialization; the tail rows are padded once
    with zero weight and ride through every shuffled epoch masked out of
    the loss. A single-batch epoch skips the shuffle: batch composition
    does not change under a permutation."""
    from mmlspark_tpu_torch.parallel.trainer import DeviceEpochCache
    n = frame.count()
    if n == 0:
        raise ValueError("empty frame")
    d = np.asarray(frame.head(1)[0][fcol]).size
    steps = int(np.ceil(n / batch_size))
    padded = steps * batch_size
    shuffle = steps > 1
    stand_in = {
        "x": np.broadcast_to(np.float32(0), (padded, d)),
        "y": np.broadcast_to(np.zeros((), y_dtype), (padded,)),
        "w": np.broadcast_to(np.float32(0), (padded,))}
    if not force and not DeviceEpochCache.fits(stand_in, shuffle=shuffle):
        return None
    x = np.asarray(frame.column(fcol), np.float32)
    y = np.asarray(frame.column(lcol))
    epoch = dict(zip(("x", "y", "w"),
                     _pad_xyw({fcol: x, lcol: y}, fcol, lcol, padded,
                              y_dtype)))
    return DeviceEpochCache(epoch, batch_size, shuffle=shuffle, seed=seed,
                            device=device)


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
