"""MultiColumnAdapter: apply a unary stage over many column pairs.

The PyTorch port's own copy of ``mmlspark_tpu/feature/multi_column_adapter.py``.

Re-expression of ``multi-column-adapter/src/main/scala/MultiColumnAdapter.scala``:
takes a base stage with inputCol/outputCol params plus parallel lists of
input and output column names, and applies a per-pair copy of the stage in
sequence (``transform`` at ``MultiColumnAdapter.scala:91-99``).

Beyond the reference (which only accepts Transformers), an Estimator base is
supported via :meth:`MultiColumnAdapter.fit`, returning a PipelineModel of
the per-column fitted models — this is what lets Featurize one-hot many
categorical columns with a single ValueIndexer config.
"""
from __future__ import annotations

from typing import List, Tuple

from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.core.params import AnyParam, ListParam, ParamException
from mmlspark_tpu_torch.core.pipeline import Estimator, PipelineModel, Transformer
from mmlspark_tpu_torch.core.schema import Schema, SchemaError
from mmlspark_tpu_torch.core.serialization import register_stage


def _check_unary(stage) -> None:
    names = {p.name for p in stage.params()}
    if "inputCol" not in names or "outputCol" not in names:
        raise ParamException(
            "baseStage must be a unary stage with inputCol and outputCol "
            f"params; {type(stage).__name__} has {sorted(names)}")


@register_stage
class MultiColumnAdapter(Estimator):
    """Applies ``baseStage`` to every (inputCols[i] -> outputCols[i]) pair.

    ``transform`` works directly when the base is a Transformer (reference
    behavior); ``fit`` additionally supports Estimator bases.
    """

    baseStage = AnyParam("baseStage", "unary stage applied to every column pair")
    inputCols = ListParam("inputCols", "input column names", [])
    outputCols = ListParam("outputCols", "output column names", [])

    def _pairs(self) -> List[Tuple[str, str]]:
        ins, outs = self.get("inputCols"), self.get("outputCols")
        if len(ins) != len(outs):
            raise ParamException(
                f"inputCols ({len(ins)}) and outputCols ({len(outs)}) must "
                "have the same length")
        if not ins:
            raise ParamException("inputCols is empty")
        return list(zip(ins, outs))

    def _per_pair(self, in_col: str, out_col: str):
        stage = self.get("baseStage").copy()
        return stage.set_params(inputCol=in_col, outputCol=out_col)

    def _verify(self, frame: Frame) -> None:
        outs = [o for _, o in self._pairs()]
        if len(set(outs)) != len(outs):
            raise ParamException(f"duplicate output column names: {outs}")
        for in_col, out_col in self._pairs():
            if in_col not in frame.schema:
                raise SchemaError(f"frame does not contain input column {in_col!r}")
            if out_col in frame.schema:
                raise SchemaError(f"frame already contains output column {out_col!r}")

    def fit(self, frame: Frame) -> PipelineModel:
        base = self.get("baseStage")
        _check_unary(base)
        self._verify(frame)
        # Each pair reads only original columns (outputs are verified absent),
        # so every stage fits directly on the input frame — no intermediate
        # transforms materialized.
        fitted: List[Transformer] = []
        for in_col, out_col in self._pairs():
            stage = self._per_pair(in_col, out_col)
            fitted.append(stage.fit(frame) if isinstance(stage, Estimator)
                          else stage)
        return PipelineModel(stages=fitted)

    def transform(self, frame: Frame) -> Frame:
        """Direct transform path for Transformer bases (reference semantics)."""
        base = self.get("baseStage")
        _check_unary(base)
        if isinstance(base, Estimator):
            raise ParamException(
                "baseStage is an Estimator; use fit() instead of transform()")
        self._verify(frame)
        for in_col, out_col in self._pairs():
            frame = self._per_pair(in_col, out_col).transform(frame)
        return frame

    def transform_schema(self, schema: Schema) -> Schema:
        base = self.get("baseStage")
        if isinstance(base, Estimator):
            raise ParamException(
                "baseStage is an Estimator; output schema is only known "
                "after fit()")
        for in_col, out_col in self._pairs():
            schema = self._per_pair(in_col, out_col).transform_schema(schema)
        return schema
