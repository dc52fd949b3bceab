"""ComputeModelStatistics: evaluator-as-transformer with metadata discovery.

The port of ``mmlspark_tpu/evaluate/compute_model_statistics.py``, the
whole module: the numpy path as it is, and the device path on torch. It
is the re-expression of
``compute-model-statistics/src/main/scala/ComputeModelStatistics.scala:86-559``:
discovers which columns are labels/scores/probabilities from column metadata
stamped by TrainedClassifierModel (``getSchemaInfo`` ``:205-218``), then:

- classification: confusion matrix, accuracy/precision/recall (binary
  ``:449-459``; multiclass micro/macro per Sokolova–Lapalme ``:375-429``),
  AUC + ROC curve retained as the ``roc_curve`` attribute (``:431-447``);
- regression: mse/rmse/r2/mae (``:181-199``).

Metric names match the reference's Spark-metric spellings
(``ComputeModelStatistics.scala:26-59``). The observable API is the same:
metrics are *returned as a Frame*.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.core.params import StringParam
from mmlspark_tpu_torch.core.pipeline import Transformer
from mmlspark_tpu_torch.core.schema import (
    ScoreKind, find_score_column, find_score_value_kind,
)
from mmlspark_tpu_torch.core.serialization import register_stage

# Spark-metric spellings (reference :26-37)
MSE, RMSE, R2, MAE = "mse", "rmse", "r2", "mae"
AUC, ACCURACY, PRECISION, RECALL = "AUC", "accuracy", "precision", "recall"
AUC_PR = "AUC_PR"
ALL_METRICS = "all"
CLASSIFICATION_METRICS = [ACCURACY, PRECISION, RECALL, AUC, AUC_PR,
                          "weighted_precision", "weighted_recall",
                          "weighted_f1"]
REGRESSION_METRICS = [MSE, RMSE, R2, MAE]


def map_labels_to_indices(arr: np.ndarray, cmap) -> np.ndarray:
    """Map raw label values (string OR numeric) to level indices; values
    outside the map get index ``num_levels`` (the unseen slot)."""
    return np.asarray(
        [cmap.get_index(v.item() if isinstance(v, np.generic) else v,
                        default=cmap.num_levels) for v in arr],
        dtype=np.int64)


def roc_curve(labels: np.ndarray, scores: np.ndarray) -> np.ndarray:
    """Binary ROC curve points (fpr, tpr) sorted by descending threshold."""
    order = np.argsort(-scores, kind="stable")
    labels = labels[order]
    tps = np.cumsum(labels)
    fps = np.cumsum(1 - labels)
    P = max(tps[-1] if len(tps) else 0, 1)
    N = max(fps[-1] if len(fps) else 0, 1)
    # keep last point per distinct score to get the staircase vertices
    distinct = np.r_[np.nonzero(np.diff(scores[order]))[0], len(labels) - 1] \
        if len(labels) else np.array([], dtype=int)
    fpr = np.r_[0.0, fps[distinct] / N]
    tpr = np.r_[0.0, tps[distinct] / P]
    return np.stack([fpr, tpr], axis=1)


def auc_from_roc(curve: np.ndarray) -> float:
    return float(np.trapezoid(curve[:, 1], curve[:, 0]))


def pr_curve(labels: np.ndarray, scores: np.ndarray) -> np.ndarray:
    """Binary precision-recall curve points (recall, precision) by
    descending threshold, with the (0, 1) anchor Spark's
    BinaryClassificationMetrics prepends — its areaUnderPR is the
    benchmark-pinned second metric column (benchmarkMetrics.csv)."""
    order = np.argsort(-scores, kind="stable")
    labels = labels[order]
    tps = np.cumsum(labels)
    fps = np.cumsum(1 - labels)
    P = max(tps[-1] if len(tps) else 0, 1)
    distinct = np.r_[np.nonzero(np.diff(scores[order]))[0], len(labels) - 1] \
        if len(labels) else np.array([], dtype=int)
    recall = np.r_[0.0, tps[distinct] / P]
    with np.errstate(divide="ignore", invalid="ignore"):
        prec = np.r_[1.0, tps[distinct] /
                     np.maximum(tps[distinct] + fps[distinct], 1)]
    return np.stack([recall, prec], axis=1)


# same trapezoid over (x, y) points; distinct name kept for call-site clarity
auc_from_pr = auc_from_roc


def confusion_matrix(y: np.ndarray, pred: np.ndarray, k: int) -> np.ndarray:
    cm = np.zeros((k, k), dtype=np.int64)
    np.add.at(cm, (y.astype(int), pred.astype(int)), 1)
    return cm


# -- device-path evaluators --------------------------------------------------
# From ``evaluate.device_rows`` rows up, the metrics are computed on
# ``runtime.device`` instead of in host numpy: the confusion matrix as an
# int32 scatter-add, and AUC / areaUnderPR from a stable descending sort,
# integer cumulative counts and a running max over masked indices, all as
# library torch ops queued back to back, with exactly ONE counted host sync
# per evaluate call (``evaluate.finalize``) that fetches the k x k counts
# and both areas together. No kernel of the JAX package stands behind this
# path (the reference ran it as one jitted XLA program). Below the
# threshold the numpy path wins on latency.

# rows are padded to a multiple of this, so the device tensors take a few
# distinct shapes rather than one per dataset length
_EVAL_CHUNK = 4096


def _device_eval(y, pred, k: int, scores=None
                 ) -> Tuple[np.ndarray, Optional[Tuple[float, float]]]:
    """Confusion matrix always, plus (AUC, areaUnderPR) when binary
    ``scores`` are given, computed on ``runtime.device`` and fetched by
    one counted host sync (``evaluate.finalize``)."""
    import torch
    from mmlspark_tpu_torch.observability import syncs
    from mmlspark_tpu_torch.utils.config import resolve_device
    device = resolve_device()
    k = int(k)
    n = len(y)
    total = max(1, -(-n // _EVAL_CHUNK)) * _EVAL_CHUNK
    yy = np.zeros((total,), np.int32)
    yy[:n] = np.asarray(y, np.int64)
    pp = np.zeros((total,), np.int32)
    pp[:n] = np.asarray(pred, np.int64)
    ww = np.zeros((total,), np.int32)
    ww[:n] = 1
    yy, pp, ww = (torch.from_numpy(a).to(device) for a in (yy, pp, ww))

    # confusion: exact int32 counts. Pad rows land in one extra cell,
    # k*k, which is dropped, so padding never counts.
    flat = torch.where(ww > 0, yy * k + pp, k * k).long()
    cm = torch.zeros(k * k + 1, dtype=torch.int32, device=device)
    cm.index_add_(0, flat, torch.ones_like(yy))  # lint: allow-embed (confusion-matrix counts)
    out = [cm[:k * k].double()]

    if scores is not None:
        # AUC + areaUnderPR, the numpy staircase + trapezoid: sort by
        # descending score (pad rows score -inf and sort last with weight
        # 0), mark the last row of each distinct score, and take each
        # marked point's trapezoid against the previous marked point,
        # found by a running max over the marked indices.
        ss = np.zeros((total,), np.float32)
        ss[:n] = np.asarray(scores, np.float32)
        s = torch.where(ww > 0, torch.from_numpy(ss).to(device),
                        float("-inf"))
        order = torch.sort(-s, stable=True).indices
        ws = ww[order]
        ys = yy[order] * ws
        sss = s[order]
        # integer cumulative counts: exact past 2^24 rows, where float32
        # sums stop counting
        tps = torch.cumsum(ys, 0)
        fps = torch.cumsum(ws - ys, 0)
        P = torch.clamp(tps[-1], min=1).float()
        N = torch.clamp(fps[-1], min=1).float()
        mask = torch.cat([sss[:-1] != sss[1:],
                          torch.ones(1, dtype=torch.bool, device=device)])
        idx = torch.arange(total, device=device)
        marked = torch.cummax(torch.where(mask, idx, -1), 0).values
        prev = torch.cat([torch.full((1,), -1, dtype=marked.dtype,
                                     device=device), marked[:-1]])
        has_prev = prev >= 0
        prev_c = torch.clamp(prev, min=0)

        def area(xcoord, ycoord, y_anchor):
            px = torch.where(has_prev, xcoord[prev_c], 0.0)
            py = torch.where(has_prev, ycoord[prev_c], y_anchor)
            return torch.where(mask, (xcoord - px) * (ycoord + py) * 0.5,
                               0.0).sum()

        tpsf, fpsf = tps.float(), fps.float()
        prec = tpsf / torch.clamp(tpsf + fpsf, min=1.0)
        out.append(area(fpsf / N, tpsf / P, 0.0).double().view(1))
        out.append(area(tpsf / P, prec, 1.0).double().view(1))
    # THE one host sync of the evaluate call: counts and areas together
    host = syncs.device_get(torch.cat(out), "evaluate.finalize")
    cm_host = host[:k * k].astype(np.int64).reshape(k, k)
    if scores is None:
        return cm_host, None
    return cm_host, (float(host[k * k]), float(host[k * k + 1]))


def binary_accuracy_precision_recall(cm: np.ndarray) -> Tuple[float, float, float]:
    """Reference getBinaryAccuracyPrecisionRecall (:449-459); positive class=1."""
    tn, fp, fn, tp = cm[0, 0], cm[0, 1], cm[1, 0], cm[1, 1]
    total = cm.sum()
    acc = (tp + tn) / total if total else 0.0
    prec = tp / (tp + fp) if (tp + fp) else 0.0
    rec = tp / (tp + fn) if (tp + fn) else 0.0
    return float(acc), float(prec), float(rec)


def multiclass_metrics(cm: np.ndarray) -> Dict[str, float]:
    """Micro/macro averaged metrics per Sokolova–Lapalme (reference :375-429)."""
    k = cm.shape[0]
    total = cm.sum()
    tp = np.diag(cm).astype(np.float64)
    fp = cm.sum(axis=0) - tp
    fn = cm.sum(axis=1) - tp
    tn = total - tp - fp - fn
    with np.errstate(divide="ignore", invalid="ignore"):
        per_prec = np.where(tp + fp > 0, tp / (tp + fp), 0.0)
        per_rec = np.where(tp + fn > 0, tp / (tp + fn), 0.0)
    micro = float(tp.sum() / total) if total else 0.0
    # support-weighted averages — Spark MulticlassMetrics.weightedFMeasure,
    # the second benchmark-pinned column for multiclass datasets
    support = cm.sum(axis=1).astype(np.float64)
    wts = support / total if total else support
    with np.errstate(divide="ignore", invalid="ignore"):
        per_f1 = np.where(per_prec + per_rec > 0,
                          2 * per_prec * per_rec / (per_prec + per_rec), 0.0)
    return {
        "average_accuracy": float(((tp + tn) / total).mean()) if total else 0.0,
        "macro_averaged_precision": float(per_prec.mean()),
        "macro_averaged_recall": float(per_rec.mean()),
        "micro_averaged_precision": micro,
        "micro_averaged_recall": micro,
        "weighted_precision": float((per_prec * wts).sum()),
        "weighted_recall": float((per_rec * wts).sum()),
        "weighted_f1": float((per_f1 * wts).sum()),
        ACCURACY: micro,
    }


@register_stage
class ComputeModelStatistics(Transformer):
    evaluationMetric = StringParam(
        "evaluationMetric", "metric to evaluate models with", ALL_METRICS)
    labelCol = StringParam("labelCol", "label column override", "")
    scoresCol = StringParam("scoresCol", "scores column override", "")
    scoredLabelsCol = StringParam("scoredLabelsCol",
                                  "scored labels column override", "")

    def __init__(self, uid=None, **kwargs):
        super().__init__(uid, **kwargs)
        self.roc_curve: Optional[np.ndarray] = None
        self.confusion_matrix: Optional[np.ndarray] = None

    def _post_load(self):
        self.roc_curve = None
        self.confusion_matrix = None

    def _discover(self, frame: Frame) -> Tuple[str, Optional[str], Optional[str], str]:
        """(label, scored_labels, scores/probabilities, kind) from metadata
        (reference getSchemaInfo :205-218)."""
        schema = frame.schema
        label = self.labelCol or find_score_column(schema, ScoreKind.TRUE_LABELS) \
            or ("label" if "label" in schema else None)
        if label is None:
            raise ValueError("cannot discover label column: no TRUE_LABELS "
                             "metadata and no labelCol override")
        kind = find_score_value_kind(schema) or ScoreKind.CLASSIFICATION
        scored_labels = self.scoredLabelsCol or find_score_column(
            schema, ScoreKind.SCORED_LABELS)
        scores = self.scoresCol or find_score_column(
            schema, ScoreKind.SCORED_PROBABILITIES) or find_score_column(
            schema, ScoreKind.SCORES)
        return label, scored_labels, scores, kind

    def transform(self, frame: Frame) -> Frame:
        self.roc_curve = None          # reset per-call so reuse never reads
        self.confusion_matrix = None   # a previous dataset's artifacts
        label, scored_labels, scores, kind = self._discover(frame)
        if kind == ScoreKind.REGRESSION:
            return self._regression(frame, label, scores)
        return self._classification(frame, label, scored_labels, scores)

    # evaluators are pass-through in schema terms; they RETURN a new frame
    def _regression(self, frame: Frame, label: str, scores: Optional[str]) -> Frame:
        if scores is None:
            raise ValueError("no scores column found for regression metrics")
        y = np.asarray(frame.column(label), dtype=np.float64)
        pred = np.asarray(frame.column(scores), dtype=np.float64)
        err = pred - y
        mse = float((err ** 2).mean()) if len(y) else 0.0
        ss_tot = float(((y - y.mean()) ** 2).sum()) if len(y) else 0.0
        metrics = {
            MSE: mse,
            RMSE: float(np.sqrt(mse)),
            R2: 1.0 - float((err ** 2).sum()) / ss_tot if ss_tot else 0.0,
            MAE: float(np.abs(err).mean()) if len(y) else 0.0,
        }
        return self._metrics_frame(metrics, REGRESSION_METRICS)

    def _classification(self, frame: Frame, label: str,
                        scored_labels: Optional[str],
                        scores: Optional[str]) -> Frame:
        if scored_labels is None:
            raise ValueError("no scored-labels column found for classification")
        y = self._label_indices(frame, label, scored_labels)
        pred = np.asarray(frame.column(scored_labels),
                          dtype=np.float64).astype(np.int64)
        k = int(max(y.max(initial=0), pred.max(initial=0))) + 1
        from mmlspark_tpu_torch.utils import config as mmlconfig
        on_device = len(y) >= int(mmlconfig.get("evaluate.device_rows"))

        pos = None
        if k == 2 and scores is not None:
            sc = np.asarray(frame.column(scores))
            pos = sc[:, 1] if sc.ndim == 2 and sc.shape[1] >= 2 else sc.ravel()

        metrics: Dict[str, float] = {}
        if on_device:
            if pos is not None:
                # the full ROC staircase (n points) is not fetched to the
                # host above the threshold; only the metric scalars come
                # back — say so, because callers that expect the roc_curve
                # artifact get None here
                from mmlspark_tpu_torch.utils.logging import get_logger
                get_logger("evaluate").info(
                    "device-path evaluation (%d rows >= "
                    "evaluate.device_rows): roc_curve artifact not "
                    "materialized; lower the threshold to retain it",
                    len(y))
            cm, auc_pair = _device_eval(y, pred, k, pos)
            self.confusion_matrix = cm
            metrics.update(self._metrics_from_cm(cm))
            if auc_pair is not None:
                metrics[AUC], metrics[AUC_PR] = auc_pair
        else:
            cm = confusion_matrix(y, pred, k)
            self.confusion_matrix = cm
            metrics.update(self._metrics_from_cm(cm))
            if pos is not None:
                curve = roc_curve(y, pos.astype(np.float64))
                self.roc_curve = curve
                metrics[AUC] = auc_from_roc(curve)
                metrics[AUC_PR] = auc_from_pr(
                    pr_curve(y, pos.astype(np.float64)))
        return self._metrics_frame(metrics, CLASSIFICATION_METRICS)

    @staticmethod
    def _metrics_from_cm(cm: np.ndarray) -> Dict[str, float]:
        """Confusion-derived metrics, shared by the fused-device and numpy
        paths (both hand over the same exact integer counts)."""
        if cm.shape[0] == 2:
            acc, prec, rec = binary_accuracy_precision_recall(cm)
            return {ACCURACY: acc, PRECISION: prec, RECALL: rec}
        mc = multiclass_metrics(cm)
        mc[PRECISION] = mc["micro_averaged_precision"]
        mc[RECALL] = mc["micro_averaged_recall"]
        return mc

    def _label_indices(self, frame: Frame, label: str,
                       scored_labels: str) -> np.ndarray:
        """Raw labels -> class indices, via the level map the trained model
        stamped on the label/scored-labels columns (TrainedClassifierModel).

        The map applies to NUMERIC labels too: levels [3, 5, 7] index to
        0..2, and scored_labels are indices — comparing raw values against
        indices would produce garbage metrics."""
        arr = frame.column(label)
        cmap = frame.schema[label].categorical \
            or frame.schema[scored_labels].categorical
        if cmap is None:
            if arr.dtype == np.object_:
                raise ValueError(
                    f"label column {label!r} holds strings but no categorical "
                    "level metadata is attached to map them to indices")
            return np.asarray(arr, dtype=np.float64).astype(np.int64)
        return map_labels_to_indices(arr, cmap)

    def _metrics_frame(self, metrics: Dict[str, float], order: List[str]) -> Frame:
        # Log through the MetricData contract, like the reference's
        # accuracy/ROC table logging (ComputeModelStatistics.scala:486-521).
        from mmlspark_tpu_torch.core import metrics as metric_data
        for name, value in metrics.items():
            metric_data.create(name, value, model_uid=self.uid).log()
        if self.confusion_matrix is not None:
            k = self.confusion_matrix.shape[0]
            metric_data.create_table(
                "confusion_matrix", [str(i) for i in range(k)],
                self.confusion_matrix, model_uid=self.uid).log()
        if self.roc_curve is not None:
            metric_data.create_table(
                "roc_curve", ["fpr", "tpr"],
                self.roc_curve, model_uid=self.uid).log()
        want = self.evaluationMetric
        if want != ALL_METRICS:
            if want not in metrics:
                raise ValueError(f"metric {want!r} unavailable; have "
                                 f"{sorted(metrics)}")
            return Frame.from_dict({want: [metrics[want]]})
        ordered = {m: [metrics[m]] for m in order if m in metrics}
        for m, v in metrics.items():
            if m not in ordered:
                ordered[m] = [v]
        return Frame.from_dict(ordered)
