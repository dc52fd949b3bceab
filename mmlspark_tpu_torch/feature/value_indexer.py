"""ValueIndexer / IndexToValue: categorical level indexing with null handling.

The PyTorch port's own copy of ``mmlspark_tpu/feature/value_indexer.py``.

Re-expression of the reference's StringIndexer generalization
(``value-indexer/src/main/scala/ValueIndexer.scala:67-169``,
``IndexToValue.scala:27-70``):

- ``fit`` collects distinct values of Int/Long/Double/String/Bool columns,
  sorts them (nulls last), and produces a model mapping level -> index.
- null/NaN map to ``num_levels``; unseen values map to ``num_levels`` when no
  null level exists, else ``num_levels + 1`` (exact reference semantics,
  ``ValueIndexer.scala:145-169``).
- The output column carries the CategoricalMap in its metadata, which is what
  ``IndexToValue`` and the evaluators read back.

:class:`HashIndexer` is the VOCABULARY-FREE sibling for embedding-table
ids (the recommender path): no fit pass, no level list to ship — any
categorical value hashes to a stable bucket in ``[1, numBuckets)`` via
the same Spark-parity murmur3 the text featurizers use, and null/NaN
map to 0, ``embed.tables.PAD_ID`` — the reserved all-zero pad row whose
lookup weight is 0. Where ``ValueIndexer`` must see the whole column to
sort levels (and breaks on unseen values), ``HashIndexer`` indexes
streams it has never seen, which is what an online scoring path needs.
"""
from __future__ import annotations

import math
from typing import Any, List

import numpy as np

from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.core.params import (HasInputCol, HasOutputCol, IntParam,
                                      ListParam)
from mmlspark_tpu_torch.core.pipeline import Estimator, Model, Transformer
from mmlspark_tpu_torch.core.schema import CategoricalMap, ColumnSchema, DType, SchemaError
from mmlspark_tpu_torch.core.serialization import register_stage


def _is_nanlike(v: Any) -> bool:
    return v is None or (isinstance(v, (float, np.floating)) and math.isnan(v))


@register_stage
class ValueIndexer(HasInputCol, HasOutputCol, Estimator):
    """Collect distinct values of a column and index them as a categorical."""

    def fit(self, frame: Frame) -> "ValueIndexerModel":
        dtype = frame.schema[self.inputCol].dtype
        if dtype in (DType.VECTOR, DType.IMAGE, DType.BINARY, DType.TOKENS):
            raise SchemaError(f"unsupported categorical type {dtype.value}")
        distinct = frame.distinct_values(self.inputCol)
        has_null = any(_is_nanlike(v) for v in distinct)
        levels = sorted(
            (v.item() if isinstance(v, np.generic) else v
             for v in distinct if not _is_nanlike(v)))
        model = ValueIndexerModel(
            inputCol=self.inputCol, outputCol=self.outputCol)
        model._state = {"levels": levels, "has_null_level": has_null,
                        "input_dtype": dtype.value}
        return model


@register_stage
class ValueIndexerModel(HasInputCol, HasOutputCol, Model):
    @property
    def categorical_map(self) -> CategoricalMap:
        return CategoricalMap(self._state["levels"],
                              bool(self._state["has_null_level"]))

    def transform(self, frame: Frame) -> Frame:
        cmap = self.categorical_map
        num = cmap.num_levels
        unknown = num if not cmap.has_null_level else num + 1

        def index_part(p):
            arr = p[self.inputCol]
            out = np.empty(len(arr), dtype=np.int32)
            for i, v in enumerate(arr):
                if _is_nanlike(v):
                    out[i] = num
                else:
                    key = v.item() if isinstance(v, np.generic) else v
                    out[i] = cmap.get_index(key, default=unknown)
            return out

        col = ColumnSchema(self.outputCol, DType.INT32,
                           metadata={"categorical": cmap.to_metadata(),
                                     "original_dtype": self._state["input_dtype"]})
        return frame.with_column(col, index_part)

    def transform_schema(self, schema):
        cmap = self.categorical_map
        return schema.add(ColumnSchema(
            self.outputCol, DType.INT32,
            metadata={"categorical": cmap.to_metadata(),
                      "original_dtype": self._state["input_dtype"]}))


@register_stage
class HashIndexer(HasInputCol, HasOutputCol, Transformer):
    """Stateless categorical-to-id hashing for embedding tables.

    ``numBuckets`` is the table's row count INCLUDING the reserved pad
    row: real values land in ``[1, numBuckets)`` (murmur3 of the value's
    canonical string, Spark seed — stable across processes and restarts,
    unlike Python's salted ``hash``), null/NaN land on 0 (the pad row,
    masked to zero weight by the bag lookup). Collisions are the
    accepted trade for never shipping a vocabulary; size ``numBuckets``
    to the table, not the cardinality.
    """

    numBuckets = IntParam(
        "numBuckets", "embedding-table rows incl. the pad row 0; real "
        "ids land in [1, numBuckets)", 1 << 16,
        validator=lambda v: v >= 2)

    def transform(self, frame: Frame) -> Frame:
        dtype = frame.schema[self.inputCol].dtype
        if dtype in (DType.VECTOR, DType.IMAGE, DType.BINARY, DType.TOKENS):
            raise SchemaError(f"unsupported categorical type {dtype.value}")
        from mmlspark_tpu_torch.ops.hashing import murmur3_batch
        buckets = int(self.numBuckets)

        def index_part(p):
            arr = p[self.inputCol]
            keys, real_pos = [], []
            out = np.zeros(len(arr), dtype=np.int32)   # nulls stay on pad
            for i, v in enumerate(arr):
                if _is_nanlike(v):
                    continue
                key = v.item() if isinstance(v, np.generic) else v
                keys.append(_canonical_str(key))
                real_pos.append(i)
            if keys:
                h = murmur3_batch(keys).astype(np.int64)
                out[real_pos] = 1 + (h % np.int64(buckets - 1))
            return out

        return frame.with_column(
            ColumnSchema(self.outputCol, DType.INT32,
                         metadata={"hash_buckets": buckets, "pad_id": 0}),
            index_part)

    def transform_schema(self, schema):
        return schema.add(ColumnSchema(
            self.outputCol, DType.INT32,
            metadata={"hash_buckets": int(self.numBuckets), "pad_id": 0}))


def _canonical_str(v: Any) -> str:
    """One spelling per value across dtypes: ints never pick up a float
    suffix (``3`` and ``3.0`` hash identically — a column that arrives
    int64 in training and float64 in serving must agree), bools hash as
    their ints."""
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


@register_stage
class IndexToValue(HasInputCol, HasOutputCol, Transformer):
    """Inverse of ValueIndexerModel via the CategoricalMap in column metadata.

    Reference: ``value-indexer/src/main/scala/IndexToValue.scala:27-70``.
    """

    def transform(self, frame: Frame) -> Frame:
        in_schema = frame.schema[self.inputCol]
        cmap = in_schema.categorical
        if cmap is None:
            raise SchemaError(
                f"column {self.inputCol!r} has no categorical metadata")
        orig = DType(in_schema.metadata.get("original_dtype", DType.STRING.value))

        def invert(p):
            arr = p[self.inputCol]
            out: List[Any] = []
            for idx in arr:
                i = int(idx)
                out.append(cmap.get_level(i) if 0 <= i < cmap.num_levels else None)
            return out

        return frame.with_column(ColumnSchema(self.outputCol, orig), invert)
