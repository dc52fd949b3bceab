"""ComputePerInstanceStatistics: per-row evaluation metrics.

The PyTorch port's own copy of ``mmlspark_tpu/evaluate/compute_per_instance_statistics.py``.

Re-expression of
``compute-per-instance-statistics/src/main/scala/ComputePerInstanceStatistics.scala:36-92``:

- classification: per-row ``log_loss`` with eps=1e-15 clipping and the
  unseen-label penalty ``-log(eps)`` when the true-label index falls outside
  the probability vector (reference ``:64-90``);
- regression: per-row ``L1_loss`` and ``L2_loss``.

Column discovery rides the same score metadata as ComputeModelStatistics.
"""
from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.core.pipeline import Transformer
from mmlspark_tpu_torch.core.schema import ColumnSchema, DType, ScoreKind, find_score_column, find_score_value_kind
from mmlspark_tpu_torch.core.serialization import register_stage
from mmlspark_tpu_torch.core.params import StringParam

EPSILON = 1e-15  # reference epsilon (ComputePerInstanceStatistics.scala:67)


@register_stage
class ComputePerInstanceStatistics(Transformer):
    labelCol = StringParam("labelCol", "label column override", "")

    def transform(self, frame: Frame) -> Frame:
        schema = frame.schema
        label = self.labelCol or find_score_column(schema, ScoreKind.TRUE_LABELS) \
            or ("label" if "label" in schema else None)
        if label is None:
            raise ValueError("cannot discover label column")
        kind = find_score_value_kind(schema) or ScoreKind.CLASSIFICATION

        if kind == ScoreKind.REGRESSION:
            scores = find_score_column(schema, ScoreKind.SCORES)
            if scores is None:
                raise ValueError("no scores column for regression")

            def l1(p):
                return np.abs(np.asarray(p[scores], np.float64)
                              - np.asarray(p[label], np.float64))

            def l2(p):
                d = np.asarray(p[scores], np.float64) \
                    - np.asarray(p[label], np.float64)
                return d * d

            out = frame.with_column(ColumnSchema("L1_loss", DType.FLOAT64), l1)
            return out.with_column(ColumnSchema("L2_loss", DType.FLOAT64), l2)

        probs_col = find_score_column(schema, ScoreKind.SCORED_PROBABILITIES)
        if probs_col is None:
            raise ValueError("no scored-probabilities column for log_loss")
        scored_labels = find_score_column(schema, ScoreKind.SCORED_LABELS)
        cmap = schema[label].categorical or (
            schema[scored_labels].categorical if scored_labels else None)

        def log_loss(p):
            from mmlspark_tpu_torch.evaluate.compute_model_statistics import (
                map_labels_to_indices)
            probs = np.asarray(p[probs_col], np.float64)
            raw = p[label]
            if cmap is not None:
                # numeric labels need mapping too: levels [3,5,7] -> 0..2
                idx = map_labels_to_indices(raw, cmap)
            elif raw.dtype == np.object_:
                raise ValueError(
                    f"label column {label!r} holds strings but carries no "
                    "categorical metadata")
            else:
                idx = np.asarray(raw, np.float64).astype(np.int64)
            n, k = probs.shape
            out = np.full(n, -np.log(EPSILON))  # unseen-label penalty
            in_range = (idx >= 0) & (idx < k)
            rows = np.nonzero(in_range)[0]
            clipped = np.clip(probs[rows, idx[rows]], EPSILON, 1 - EPSILON)
            out[rows] = -np.log(clipped)
            return out

        return frame.with_column(ColumnSchema("log_loss", DType.FLOAT64), log_loss)
