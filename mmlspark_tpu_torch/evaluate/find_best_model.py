"""FindBestModel: model selection over a list of fitted transformers.

The PyTorch port's own copy of ``mmlspark_tpu/evaluate/find_best_model.py``.

Re-expression of ``find-best-model/src/main/scala/FindBestModel.scala:68-162``:
scores the dataset with each candidate, evaluates the chosen metric,
dispatches higher-vs-lower-is-better by metric, and retains the best model,
its scored dataset, its ROC curve, and a table of all models' metrics.

Candidates are evaluated embarrassingly-parallel in the reference sense (a
sequential loop there, ``:135-143``); each candidate's scoring already
runs batched on the device here.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.core.params import AnyParam, StringParam
from mmlspark_tpu_torch.core.pipeline import Estimator, Model, Transformer
from mmlspark_tpu_torch.core.serialization import register_stage
from mmlspark_tpu_torch.evaluate.compute_model_statistics import (
    ACCURACY, AUC, ALL_METRICS, CLASSIFICATION_METRICS, MAE, MSE, PRECISION,
    R2, RECALL, RMSE, ComputeModelStatistics,
)

LOWER_IS_BETTER = {MSE, RMSE, MAE}
# derived, not hand-listed: a metric added to the evaluator must be
# rankable here without anyone remembering a second list
HIGHER_IS_BETTER = set(CLASSIFICATION_METRICS) | {R2}


@register_stage
class FindBestModel(Estimator):
    models = AnyParam("models", "candidate fitted transformers to compare")
    evaluationMetric = StringParam(
        "evaluationMetric", "metric used to rank candidates", ACCURACY)

    def fit(self, frame: Frame) -> "BestModel":
        candidates: List[Transformer] = self.get("models")
        if not candidates:
            raise ValueError("FindBestModel requires a non-empty `models` list")
        metric = self.evaluationMetric
        if metric == ALL_METRICS:
            raise ValueError("evaluationMetric must be a single metric")
        lower = metric in LOWER_IS_BETTER
        if not lower and metric not in HIGHER_IS_BETTER:
            raise ValueError(f"unknown metric {metric!r}")

        # Featurize ONCE per distinct featurization: candidates whose
        # featurizeModel fingerprints identically (typical when several
        # learners were trained by TrainClassifier on the same data) share
        # a single featurize pass, so N-candidate selection costs ~one
        # pass over the data plus N cheap scoring heads — the reference
        # re-ran the whole pipeline per candidate
        # (``FindBestModel.scala:135-143``).
        from mmlspark_tpu_torch.core.serialization import stage_fingerprint
        featurized_cache: dict = {}

        def score(cand):
            featurizer = (cand.get("featurizeModel", None)
                          if hasattr(cand, "transform_featurized") else None)
            if featurizer is None:
                return cand.transform(frame)
            fp = stage_fingerprint(featurizer)
            if fp not in featurized_cache:
                featurized_cache[fp] = featurizer.transform(frame)
            return cand.transform_featurized(featurized_cache[fp])

        rows = []
        best = None  # (value, model, scored, roc)
        for cand in candidates:
            scored = score(cand)
            ev = ComputeModelStatistics()
            all_metrics = {k: v[0] for k, v in ev.transform(scored).collect().items()}
            if metric not in all_metrics:
                raise ValueError(
                    f"metric {metric!r} unavailable for model {cand.uid} "
                    f"(have {sorted(all_metrics)})")
            value = float(all_metrics[metric])
            rows.append({"model_uid": cand.uid,
                         **{k: float(v) for k, v in all_metrics.items()}})
            better = (best is None or
                      (value < best[0] if lower else value > best[0]))
            if better:
                best = (value, cand, scored, ev.roc_curve)

        model = BestModel()
        model.set_params(bestModel=best[1])
        model._state = {"best_metric": best[0], "metric_name": metric}
        model.scored_dataset = best[2]
        model.roc_curve = best[3]
        model.all_model_metrics = Frame.from_rows(rows)
        return model


@register_stage
class BestModel(Model):
    bestModel = AnyParam("bestModel", "the winning transformer")

    def __init__(self, uid=None, **kwargs):
        super().__init__(uid, **kwargs)
        self._post_load()

    def _post_load(self):
        self.scored_dataset: Optional[Frame] = None
        self.roc_curve = None
        self.all_model_metrics: Optional[Frame] = None

    def transform(self, frame: Frame) -> Frame:
        return self.get("bestModel").transform(frame)
