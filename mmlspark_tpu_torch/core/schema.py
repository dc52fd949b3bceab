"""Column schema + metadata: the glue that lets evaluators discover columns.

The PyTorch port's own copy of ``mmlspark_tpu/core/schema.py``.

Re-expression of the reference's schema layer:
- ``SchemaConstants`` (``core/schema/src/main/scala/SchemaConstants.scala:9-45``)
- ``SparkSchema`` score-column tagging/discovery (``SparkSchema.scala:26-245``)
- ``Categoricals`` level<->index maps with null handling
  (``Categoricals.scala:187-356``)
- ``ImageSchema``/``BinaryFileSchema`` column types
  (``ImageSchema.scala:18-23``, ``BinaryFileSchema.scala:14-17``)

Design: metadata rides on the Frame's per-column ``ColumnSchema``
as plain JSON-able dicts, so it survives save/load and streams with the data
into device tensors without a JVM metadata dialect.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


class DType(str, enum.Enum):
    BOOL = "bool"
    INT32 = "int32"
    INT64 = "int64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    STRING = "string"
    BINARY = "binary"      # bytes per row (reference BinaryFileSchema)
    VECTOR = "vector"      # fixed-dim vector per row (2D ndarray storage;
                           # float32 canonical, uint8 permitted as the
                           # raw-bytes wire format — cast before arithmetic)
    IMAGE = "image"        # decoded image struct per row (reference ImageSchema)
    TOKENS = "tokens"      # list[str] per row (tokenizer output)

    @property
    def is_numeric(self) -> bool:
        return self in (DType.BOOL, DType.INT32, DType.INT64, DType.FLOAT32, DType.FLOAT64)

    @property
    def numpy_dtype(self):
        return {
            DType.BOOL: np.bool_, DType.INT32: np.int32, DType.INT64: np.int64,
            DType.FLOAT32: np.float32, DType.FLOAT64: np.float64,
        }.get(self, np.object_)


# -- score-column metadata tags (reference SchemaConstants.scala:9-45) -------
class ScoreKind:
    MML = "mml"                     # metadata namespace key
    SCORES = "scores"
    SCORED_LABELS = "scored_labels"
    SCORED_PROBABILITIES = "scored_probabilities"
    TRUE_LABELS = "true_labels"
    RAW_PREDICTION = "raw_prediction"

    CLASSIFICATION = "classification"
    REGRESSION = "regression"


class SchemaError(ValueError):
    pass


@dataclass
class CategoricalMap:
    """level <-> index map with optional null level.

    Reference ``CategoricalMap[T]`` (``Categoricals.scala:187-262``): stores
    ordered levels, optionally treats one index as the null/missing level,
    serializes into column metadata.
    """
    levels: List[Any]
    has_null_level: bool = False

    def __post_init__(self):
        self._index: Dict[Any, int] = {v: i for i, v in enumerate(self.levels)}

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def get_index(self, level: Any, default: Optional[int] = None) -> int:
        idx = self._index.get(level, -1)
        if idx >= 0:
            return idx
        if default is not None:
            return default
        raise SchemaError(f"level {level!r} not found in categorical map")

    def get_level(self, index: int) -> Any:
        if 0 <= index < len(self.levels):
            return self.levels[index]
        raise SchemaError(f"index {index} out of range [0, {len(self.levels)})")

    def to_metadata(self) -> Dict[str, Any]:
        return {"levels": list(self.levels), "has_null_level": self.has_null_level}

    @staticmethod
    def from_metadata(md: Dict[str, Any]) -> "CategoricalMap":
        return CategoricalMap(list(md["levels"]), bool(md.get("has_null_level", False)))


@dataclass
class ColumnSchema:
    """Name, type, per-column metadata; VECTOR columns carry their dim.

    ``metadata`` keys in use:
      - ``categorical``: CategoricalMap.to_metadata() payload
      - ``score_kind``: one of ScoreKind.{SCORES,...}
      - ``score_value_kind``: ScoreKind.{CLASSIFICATION,REGRESSION}
      - ``model_uid``: uid of the model that produced the column
    """
    name: str
    dtype: DType
    dim: Optional[int] = None          # for VECTOR columns
    metadata: Dict[str, Any] = field(default_factory=dict)

    def with_meta(self, **kv) -> "ColumnSchema":
        md = dict(self.metadata)
        md.update(kv)
        return ColumnSchema(self.name, self.dtype, self.dim, md)

    def renamed(self, name: str) -> "ColumnSchema":
        return ColumnSchema(name, self.dtype, self.dim, dict(self.metadata))

    @property
    def categorical(self) -> Optional[CategoricalMap]:
        md = self.metadata.get("categorical")
        return CategoricalMap.from_metadata(md) if md else None

    @property
    def is_categorical(self) -> bool:
        return "categorical" in self.metadata

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name, "dtype": self.dtype.value, "dim": self.dim,
                "metadata": self.metadata}

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "ColumnSchema":
        return ColumnSchema(d["name"], DType(d["dtype"]), d.get("dim"),
                            dict(d.get("metadata", {})))


@dataclass
class Schema:
    columns: List[ColumnSchema]

    def __post_init__(self):
        names = [c.name for c in self.columns]
        if len(set(names)) != len(names):
            raise SchemaError(f"duplicate column names in schema: {names}")

    @property
    def names(self) -> List[str]:
        return [c.name for c in self.columns]

    def __contains__(self, name: str) -> bool:
        return any(c.name == name for c in self.columns)

    def __getitem__(self, name: str) -> ColumnSchema:
        for c in self.columns:
            if c.name == name:
                return c
        raise SchemaError(f"column {name!r} not in schema (have {self.names})")

    def __iter__(self):
        return iter(self.columns)

    def select(self, names: Sequence[str]) -> "Schema":
        return Schema([self[n] for n in names])

    def drop(self, names: Sequence[str]) -> "Schema":
        names = set(names)
        return Schema([c for c in self.columns if c.name not in names])

    def add(self, col: ColumnSchema) -> "Schema":
        if col.name in self:
            return Schema([col if c.name == col.name else c for c in self.columns])
        return Schema(self.columns + [col])

    def find_unused_name(self, prefix: str) -> str:
        """Collision-free temp column name (reference DatasetExtensions.scala:23-40)."""
        if prefix not in self:
            return prefix
        i = 1
        while f"{prefix}_{i}" in self:
            i += 1
        return f"{prefix}_{i}"

    def to_json(self) -> List[Dict[str, Any]]:
        return [c.to_json() for c in self.columns]

    @staticmethod
    def from_json(lst: List[Dict[str, Any]]) -> "Schema":
        return Schema([ColumnSchema.from_json(d) for d in lst])


# -- score-column tagging/discovery (reference SparkSchema.scala) ------------
def set_score_column(schema: Schema, col: str, model_uid: str, score_kind: str,
                     score_value_kind: str) -> Schema:
    """Stamp score metadata on a column so evaluators can discover it.

    Reference: ``SparkSchema.scala`` setters at ``:26-63`` / ``updateMetadata``
    at ``:209-236``.
    """
    tagged = schema[col].with_meta(
        score_kind=score_kind, score_value_kind=score_value_kind, model_uid=model_uid)
    return schema.add(tagged)


def find_score_column(schema: Schema, score_kind: str,
                      model_uid: Optional[str] = None) -> Optional[str]:
    """Find the column tagged with a given score kind (SparkSchema getters :72-143)."""
    for c in schema:
        if c.metadata.get("score_kind") == score_kind:
            if model_uid is None or c.metadata.get("model_uid") == model_uid:
                return c.name
    return None


def find_score_value_kind(schema: Schema) -> Optional[str]:
    """Classification vs regression, discovered from any scored column."""
    for c in schema:
        if "score_value_kind" in c.metadata:
            return c.metadata["score_value_kind"]
    return None


# -- image schema (reference ImageSchema.scala:18-23) ------------------------
@dataclass
class ImageValue:
    """One decoded image: uint8 HWC array in BGR channel order + provenance.

    The reference stores ``(path, height, width, type, bytes)`` with row-wise
    BGR bytes (OpenCV CV_8U). We keep the same logical fields but store the
    pixels as a numpy array so device featurization can stack batches without
    re-parsing bytes.
    """
    path: Optional[str]
    data: np.ndarray  # uint8, shape (H, W, C), BGR

    @property
    def height(self) -> int:
        return int(self.data.shape[0])

    @property
    def width(self) -> int:
        return int(self.data.shape[1])

    @property
    def channels(self) -> int:
        return int(self.data.shape[2]) if self.data.ndim == 3 else 1
