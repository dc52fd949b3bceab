"""TrainClassifier / TrainRegressor: one-line auto-featurize + train wrappers.

The PyTorch port's own copy of ``mmlspark_tpu/train/train_classifier.py``.

Re-expression of the reference AutoML path
(``train-classifier/src/main/scala/TrainClassifier.scala:81-337``,
``train-regressor/src/main/scala/TrainRegressor.scala:43-117``):

- label conversion: reindex labels through ValueIndexer (``convertLabel``,
  ``TrainClassifier.scala:187-233``), remember the levels;
- learner-dependent featurize params (``getFeaturizeParams`` ``:170-185``):
  tree/NN learners get a 2^12 hash space, trees skip one-hot — expressed
  here as a ``FeaturizeHints`` attribute on each learner;
- fit featurizer then learner; produce a model that re-featurizes at scoring
  time, renames prediction/rawPrediction/probability to
  scored_labels/scores/scored_probabilities, and stamps score metadata +
  label levels on the output columns (``TrainedClassifierModel.transform``
  ``:286-337``) so ComputeModelStatistics can discover them.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.core.params import AnyParam, HasLabelCol, IntParam, ListParam
from mmlspark_tpu_torch.core.pipeline import Estimator, Model
from mmlspark_tpu_torch.core.schema import (
    CategoricalMap, ColumnSchema, DType, ScoreKind,
)
from mmlspark_tpu_torch.core.serialization import register_stage
from mmlspark_tpu_torch.feature.featurize import Featurize
from mmlspark_tpu_torch.feature.value_indexer import ValueIndexer
from mmlspark_tpu_torch.train.learners import FeaturizeHints


@register_stage
class TrainClassifier(HasLabelCol, Estimator):
    model = AnyParam("model", "the classifier learner to fit")
    numFeatures = IntParam("numFeatures", "override hash space size", 0)
    labels = ListParam("labels", "optional explicit label ordering", None)

    def fit(self, frame: Frame) -> "TrainedClassifierModel":
        learner = self.get("model")
        if learner is None:
            raise ValueError("TrainClassifier requires a `model` learner")
        label_col = self.labelCol

        # -- label conversion (reference convertLabel :187-233)
        frame = frame.na_drop([label_col])
        indexed_col = frame.schema.find_unused_name("_indexed_label")
        explicit = self.get("labels")
        if explicit:
            cmap = CategoricalMap(list(explicit))
            def to_index(p):
                return np.asarray(
                    [cmap.get_index(v.item() if isinstance(v, np.generic) else v)
                     for v in p[label_col]], dtype=np.int32)
            indexed = frame.with_column(
                ColumnSchema(indexed_col, DType.INT32,
                             metadata={"categorical": cmap.to_metadata()}),
                to_index)
            levels = list(explicit)
        else:
            vi = ValueIndexer(inputCol=label_col, outputCol=indexed_col).fit(frame)
            indexed = vi.transform(frame)
            levels = vi._state["levels"]

        # -- learner-dependent featurization (reference :170-185)
        hints: FeaturizeHints = getattr(type(learner), "hints", FeaturizeHints())
        num_features = self.numFeatures or hints.num_features
        feature_cols = [c for c in frame.schema.names if c != label_col]
        features_col = indexed.schema.find_unused_name("features")
        featurizer = Featurize(
            featureColumns={features_col: feature_cols},
            numberOfFeatures=num_features,
            oneHotEncodeCategoricals=hints.one_hot).fit(indexed)
        processed = featurizer.transform(indexed)

        # -- fit the learner on device
        learner = learner.copy()
        learner.set_params(featuresCol=features_col, labelCol=indexed_col)
        fitted = learner.fit(processed)

        model = TrainedClassifierModel(labelCol=label_col)
        model.set_params(featurizeModel=featurizer, learnerModel=fitted)
        model._state = {"levels": levels, "features_col": features_col}
        return model


@register_stage
class TrainedClassifierModel(HasLabelCol, Model):
    featurizeModel = AnyParam("featurizeModel", "fitted featurization pipeline")
    learnerModel = AnyParam("learnerModel", "fitted classifier model")

    @property
    def levels(self) -> List:
        return self._state["levels"]

    def transform(self, frame: Frame) -> Frame:
        return self.transform_featurized(
            self.get("featurizeModel").transform(frame))

    def transform_featurized(self, featurized: Frame) -> Frame:
        """Score a frame ALREADY transformed by this model's featurizeModel.

        FindBestModel featurizes once per distinct featurization and fans
        the candidate learners out over the shared featurized frame — K
        candidates cost ~1 featurize pass, not K (the reference re-ran the
        full pipeline per candidate, ``FindBestModel.scala:135-143``)."""
        scored = self.get("learnerModel").transform(featurized)
        features_col = self._state.get("features_col", "features")
        scored = scored.drop(features_col).rename({
            "prediction": ScoreKind.SCORED_LABELS,
            "rawPrediction": ScoreKind.SCORES,
            "probability": ScoreKind.SCORED_PROBABILITIES,
        })
        cmap = CategoricalMap(self.levels)
        meta = dict(score_value_kind=ScoreKind.CLASSIFICATION, model_uid=self.uid)
        scored = scored.with_metadata(
            ScoreKind.SCORED_LABELS, score_kind=ScoreKind.SCORED_LABELS,
            categorical=cmap.to_metadata(), **meta)
        scored = scored.with_metadata(
            ScoreKind.SCORES, score_kind=ScoreKind.SCORES, **meta)
        scored = scored.with_metadata(
            ScoreKind.SCORED_PROBABILITIES,
            score_kind=ScoreKind.SCORED_PROBABILITIES, **meta)
        if self.labelCol in scored.schema:
            scored = scored.with_metadata(
                self.labelCol, score_kind=ScoreKind.TRUE_LABELS,
                categorical=cmap.to_metadata(), **meta)
        return scored


@register_stage
class TrainRegressor(HasLabelCol, Estimator):
    """Same pattern minus label indexing; string labels rejected
    (reference TrainRegressor.scala:43-117)."""

    model = AnyParam("model", "the regressor learner to fit")
    numFeatures = IntParam("numFeatures", "override hash space size", 0)

    def fit(self, frame: Frame) -> "TrainedRegressorModel":
        learner = self.get("model")
        if learner is None:
            raise ValueError("TrainRegressor requires a `model` learner")
        label_col = self.labelCol
        if frame.schema[label_col].dtype == DType.STRING:
            raise ValueError(
                f"TrainRegressor: label column {label_col!r} is a string; "
                "cast it to numeric first (reference rejects string labels)")
        frame = frame.na_drop([label_col])

        hints: FeaturizeHints = getattr(type(learner), "hints", FeaturizeHints())
        num_features = self.numFeatures or hints.num_features
        feature_cols = [c for c in frame.schema.names if c != label_col]
        features_col = frame.schema.find_unused_name("features")
        featurizer = Featurize(
            featureColumns={features_col: feature_cols},
            numberOfFeatures=num_features,
            oneHotEncodeCategoricals=hints.one_hot).fit(frame)
        processed = featurizer.transform(frame)

        learner = learner.copy()
        learner.set_params(featuresCol=features_col, labelCol=label_col)
        fitted = learner.fit(processed)

        model = TrainedRegressorModel(labelCol=label_col)
        model.set_params(featurizeModel=featurizer, learnerModel=fitted)
        model._state = {"features_col": features_col}
        return model


@register_stage
class TrainedRegressorModel(HasLabelCol, Model):
    featurizeModel = AnyParam("featurizeModel", "fitted featurization pipeline")
    learnerModel = AnyParam("learnerModel", "fitted regressor model")

    def transform(self, frame: Frame) -> Frame:
        return self.transform_featurized(
            self.get("featurizeModel").transform(frame))

    def transform_featurized(self, featurized: Frame) -> Frame:
        """Score a pre-featurized frame (see TrainedClassifierModel)."""
        scored = self.get("learnerModel").transform(featurized)
        features_col = self._state.get("features_col", "features")
        scored = scored.drop(features_col).rename(
            {"prediction": ScoreKind.SCORES})
        meta = dict(score_value_kind=ScoreKind.REGRESSION, model_uid=self.uid)
        scored = scored.with_metadata(
            ScoreKind.SCORES, score_kind=ScoreKind.SCORES, **meta)
        if self.labelCol in scored.schema:
            scored = scored.with_metadata(
                self.labelCol, score_kind=ScoreKind.TRUE_LABELS, **meta)
        return scored
