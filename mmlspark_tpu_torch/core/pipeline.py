"""Estimator / Transformer / Model / Pipeline contracts.

The PyTorch port's own copy of ``mmlspark_tpu/core/pipeline.py``. Same
user-facing contract as the reference (it is what the reference's whole
L4/L5 stack — and its users — are written against), re-hosted on Frame:
``fit``/``transform`` bodies run torch on the configured device where they
touch tensors.

Reference: Spark ML's PipelineStage hierarchy as used throughout
the reference's sources (e.g. ``TrainClassifier.scala:81``,
``Featurize.scala:67``); save/load via the serialization layer replaces
``PipelineUtilities.saveMetadata`` (``utils/src/main/scala/PipelineUtilities.scala:19-47``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.core.params import AnyParam, Params
from mmlspark_tpu_torch.core.schema import Schema
from mmlspark_tpu_torch.observability.spans import span


class PipelineStage(Params):
    """Anything that can sit in a Pipeline and be saved/loaded."""

    def save(self, path: str) -> None:
        from mmlspark_tpu_torch.core.serialization import save_stage
        save_stage(self, path)

    @classmethod
    def load(cls, path: str) -> "PipelineStage":
        from mmlspark_tpu_torch.core.serialization import load_stage
        stage = load_stage(path)
        if cls is not PipelineStage and not isinstance(stage, cls):
            raise TypeError(f"loaded {type(stage).__name__}, expected {cls.__name__}")
        return stage

    # Learned state hook: dict pytree with ndarray leaves; see serialization.py.
    def _get_state(self) -> Dict[str, Any]:
        return getattr(self, "_state", {}) or {}

    def _set_state(self, state: Dict[str, Any]) -> None:
        self._build_cache = None  # built closures are stale once state changes
        if state:
            self._state = state

    def _cached_build(self, build, key: Any = None):
        """Memoize a built closure over this stage's state (a model placed
        on the device, its preprocess constants): repeat transform() calls
        must not rebuild and re-upload it. Invalidated by _set_state and
        copy(), and by a changed ``key`` — pass the params the closure bakes
        in (output node, preprocessing spec, device, ...) so editing them
        between transforms can't serve a stale closure."""
        cached = getattr(self, "_build_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        fn = build()
        self._build_cache = (key, fn)
        return fn


class Transformer(PipelineStage):
    def transform(self, frame: Frame) -> Frame:
        raise NotImplementedError

    def transform_schema(self, schema: Schema) -> Schema:
        """Best-effort schema-out-of-schema (used by validation & codegen)."""
        return schema

    def __call__(self, frame: Frame) -> Frame:
        return self.transform(frame)


class Estimator(PipelineStage):
    def fit(self, frame: Frame) -> "Transformer":
        raise NotImplementedError


class Model(Transformer):
    """A fitted Transformer (kept as a distinct type for API parity)."""


class Pipeline(Estimator):
    """Sequential composition of stages; estimators are fitted in order and
    replaced by the models they produce, exactly like Spark's Pipeline."""

    stages = AnyParam("stages", "ordered list of pipeline stages", default=[])

    def fit(self, frame: Frame) -> "PipelineModel":
        stages = self.get("stages")
        for i, stage in enumerate(stages):
            if not isinstance(stage, (Estimator, Transformer)):
                raise TypeError(f"stage {i} ({type(stage).__name__}) is neither "
                                "Estimator nor Transformer")
        # No frame pass is needed beyond the last estimator (Spark semantics).
        last_est = max((i for i, s in enumerate(stages) if isinstance(s, Estimator)),
                       default=-1)
        fitted: List[Transformer] = []
        cur = frame
        # per-stage telemetry spans (no-ops unless observability.* is on);
        # the outer span parents them so the event log nests fit:Pipeline ->
        # fit:<Stage> -> transform:<Stage>
        with span("fit", type(self).__name__):
            for i, stage in enumerate(stages):
                if isinstance(stage, Estimator):
                    with span("fit", type(stage).__name__, stage=i):
                        model = stage.fit(cur)
                else:
                    model = stage
                if i < last_est:
                    with span("transform", type(model).__name__, stage=i):
                        cur = model.transform(cur)
                fitted.append(model)
        return PipelineModel(stages=fitted)


class PipelineModel(Model):
    stages = AnyParam("stages", "ordered list of fitted transformers", default=[])

    def transform(self, frame: Frame) -> Frame:
        with span("transform", type(self).__name__):
            for stage in self.get("stages"):
                with span("transform", type(stage).__name__):
                    frame = stage.transform(frame)
        return frame

    def transform_schema(self, schema: Schema) -> Schema:
        for stage in self.get("stages"):
            schema = stage.transform_schema(schema)
        return schema
