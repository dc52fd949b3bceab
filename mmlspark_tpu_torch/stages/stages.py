"""Data-plumbing pipeline stages (the reference's L5 surface).

The PyTorch port's own copy of ``mmlspark_tpu/stages/stages.py``.

Re-expression of:
- ``Repartition`` (``pipeline-stages/src/main/scala/Repartition.scala:15-41``)
- ``SelectColumns`` (``pipeline-stages/src/main/scala/SelectColumns.scala:22-63``)
- ``DataConversion`` (``data-conversion/src/main/scala/DataConversion.scala:22-165``)
- ``SummarizeData`` (``summarize-data/src/main/scala/SummarizeData.scala:55-189``)
- ``PartitionSample`` (``partition-sample/src/main/scala/PartitionSample.scala:81-117``)
- ``CheckpointData`` (``checkpoint-data/src/main/scala/CheckpointData.scala:31-70``)

These are host-side columnar ops on Frame partitions — no device round trip
(a repartition or type cast must not burn device memory bandwidth). Statistics in
SummarizeData are computed per-partition and merged, which is also the shape
the multi-host version takes (per-host partials + one small allreduce).
"""
from __future__ import annotations

import datetime as _dt
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np

from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.core.params import (
    BooleanParam, FloatParam, IntParam, ListParam, StringParam,
)
from mmlspark_tpu_torch.core.pipeline import Transformer
from mmlspark_tpu_torch.core.schema import ColumnSchema, DType, SchemaError
from mmlspark_tpu_torch.core.serialization import register_stage


@register_stage
class Repartition(Transformer):
    """Change the Frame's partition count; ``disable`` passes through.

    Reference semantics (``Repartition.scala:15-41``): coalesce when
    shrinking, full repartition when growing.
    """

    n = IntParam("n", "number of partitions", validator=lambda v: v > 0)
    disable = BooleanParam("disable", "pass through unchanged", False)

    def transform(self, frame: Frame) -> Frame:
        if self.disable:
            return frame
        n = self.n
        if n < frame.num_partitions:
            return frame.coalesce(n)
        return frame.repartition(n)


@register_stage
class SelectColumns(Transformer):
    """Schema-verified column projection (``SelectColumns.scala:22-63``)."""

    cols = ListParam("cols", "names of the columns to keep")

    def transform(self, frame: Frame) -> Frame:
        self._verify(frame.schema.names)
        return frame.select(*self.cols)

    def transform_schema(self, schema):
        self._verify(schema.names)
        return schema.select(self.cols)

    def _verify(self, have: List[str]) -> None:
        missing = [c for c in self.cols if c not in have]
        if missing:
            raise SchemaError(f"frame does not contain columns: {missing}")


@register_stage
class DropColumns(Transformer):
    """Inverse of SelectColumns: drop the listed columns."""

    cols = ListParam("cols", "names of the columns to drop")

    def transform(self, frame: Frame) -> Frame:
        missing = [c for c in self.cols if c not in frame.schema.names]
        if missing:
            raise SchemaError(f"frame does not contain columns: {missing}")
        return frame.drop(*self.cols)

    def transform_schema(self, schema):
        return schema.drop(self.cols)


@register_stage
class RenameColumn(Transformer):
    """Rename a column, metadata preserved."""

    inputCol = StringParam("inputCol", "current column name")
    outputCol = StringParam("outputCol", "new column name")

    def transform(self, frame: Frame) -> Frame:
        return frame.rename({self.inputCol: self.outputCol})

    def transform_schema(self, schema):
        from mmlspark_tpu_torch.core.schema import Schema
        return Schema([c.renamed(self.outputCol) if c.name == self.inputCol else c
                       for c in schema])


_NUMERIC_TARGETS = {
    "boolean": DType.BOOL, "integer": DType.INT32, "long": DType.INT64,
    "float": DType.FLOAT32, "double": DType.FLOAT64,
}


@register_stage
class DataConversion(Transformer):
    """Multi-column type conversion incl. categorical make/clear and dates.

    Reference dispatch (``DataConversion.scala:65-79``): numeric casts,
    ``toCategorical`` (ValueIndexer in place), ``clearCategorical``
    (IndexToValue in place), and date<->string/long conversions. Dates are
    held as INT64 epoch-milliseconds with a ``datetime`` metadata marker —
    a device-friendly representation (integer columns stream straight into
    device arrays), formatted only at the string boundary.
    """

    cols = ListParam("cols", "columns to convert")
    convertTo = StringParam(
        "convertTo", "target type", domain=sorted(
            list(_NUMERIC_TARGETS) + ["string", "toCategorical",
                                      "clearCategorical", "date"]))
    dateTimeFormat = StringParam(
        "dateTimeFormat", "strftime format for date<->string conversions",
        "%Y-%m-%d %H:%M:%S")

    def transform(self, frame: Frame) -> Frame:
        missing = [c for c in self.cols if c not in frame.schema.names]
        if missing:
            raise SchemaError(f"frame does not contain columns: {missing}")
        for col in self.cols:
            frame = self._convert(frame, col)
        return frame

    def _convert(self, frame: Frame, col: str) -> Frame:
        target = self.convertTo
        cs = frame.schema[col]
        if target == "toCategorical":
            from mmlspark_tpu_torch.feature.value_indexer import ValueIndexer
            model = ValueIndexer(inputCol=col, outputCol=col).fit(frame)
            return model.transform(frame)
        if target == "clearCategorical":
            from mmlspark_tpu_torch.feature.value_indexer import IndexToValue
            return IndexToValue(inputCol=col, outputCol=col).transform(frame)
        if target == "date":
            return self._to_date(frame, col, cs)
        if target == "string":
            return self._to_string(frame, col, cs)
        dtype = _NUMERIC_TARGETS[target]
        if cs.dtype == DType.STRING and dtype == DType.BOOL:
            raise SchemaError("string to boolean conversion is not supported")
        if cs.metadata.get("datetime"):  # date -> numeric: epoch millis
            if dtype != DType.INT64:
                raise SchemaError("date only converts to long or string")
            md = {k: v for k, v in cs.metadata.items() if k != "datetime"}
            return Frame(frame.schema.add(ColumnSchema(col, DType.INT64, None, md)),
                        frame.partitions)

        def cast(p):
            arr = p[col]
            if arr.dtype == np.object_:  # strings -> numeric
                out = np.empty(len(arr), np.float64)
                for i, v in enumerate(arr):
                    out[i] = np.nan if v is None or v == "" else float(v)
                arr = out
            if np.issubdtype(arr.dtype, np.floating) \
                    and np.issubdtype(dtype.numpy_dtype, np.integer) \
                    and np.isnan(arr).any():
                raise SchemaError(f"column {col!r} has missing values; cannot "
                                  f"cast to {target}")
            return arr.astype(dtype.numpy_dtype)

        return frame.with_column(ColumnSchema(col, dtype), cast)

    def _to_string(self, frame: Frame, col: str, cs: ColumnSchema) -> Frame:
        fmt = self.dateTimeFormat
        is_date = bool(cs.metadata.get("datetime"))

        def conv(p):
            arr = p[col]
            out = np.empty(len(arr), np.object_)
            for i, v in enumerate(arr):
                if is_date:
                    t = _dt.datetime.fromtimestamp(int(v) / 1000.0, _dt.timezone.utc)
                    out[i] = t.strftime(fmt)
                elif isinstance(v, (np.bool_, bool)):
                    out[i] = str(bool(v)).lower()
                elif isinstance(v, (np.integer, int)):
                    out[i] = str(int(v))
                else:
                    out[i] = str(v)
            return out

        return frame.with_column(ColumnSchema(col, DType.STRING), conv)

    def _to_date(self, frame: Frame, col: str, cs: ColumnSchema) -> Frame:
        fmt = self.dateTimeFormat
        if cs.dtype not in (DType.STRING, DType.INT64):
            raise SchemaError("can only convert string or long to date")

        def conv(p):
            arr = p[col]
            out = np.empty(len(arr), np.int64)
            for i, v in enumerate(arr):
                if cs.dtype == DType.STRING:
                    t = _dt.datetime.strptime(v, fmt).replace(
                        tzinfo=_dt.timezone.utc)
                    out[i] = int(t.timestamp() * 1000)
                else:
                    out[i] = int(v)
            return out

        return frame.with_column(
            ColumnSchema(col, DType.INT64, None, {"datetime": True}), conv)


@register_stage
class SummarizeData(Transformer):
    """Per-column statistics as a new Frame keyed by ``Feature``.

    Reference (``SummarizeData.scala:55-189``): counts (count / unique /
    missing), basic quantiles (min/quartiles/max), sample moments
    (variance/std/skew/kurtosis), tail percentiles. Sub-tables toggle via
    params and join on the feature name. Non-numeric columns yield NaN for
    numeric stats, matching the reference's ``allNaNs`` fill.
    """

    counts = BooleanParam("counts", "include count statistics", True)
    basic = BooleanParam("basic", "include basic quantile statistics", True)
    sample = BooleanParam("sample", "include sample moment statistics", True)
    percentiles = BooleanParam("percentiles", "include tail percentiles", True)
    errorThreshold = FloatParam(
        "errorThreshold", "quantile approximation error (0 = exact)", 0.0)

    _BASIC_Q = [0.0, 0.25, 0.5, 0.75, 1.0]
    _BASIC_NAMES = ["Min", "1st Quartile", "Median", "3rd Quartile", "Max"]
    _PERC_Q = [0.005, 0.01, 0.05, 0.95, 0.99, 0.995]
    _PERC_NAMES = ["P0.5", "P1", "P5", "P95", "P99", "P99.5"]

    def transform(self, frame: Frame) -> Frame:
        out: Dict[str, List[Any]] = {"Feature": []}
        tables: List[List[str]] = []
        if self.counts:
            tables.append(["Count", "Unique Value Count", "Missing Value Count"])
        if self.basic:
            tables.append(self._BASIC_NAMES)
        if self.sample:
            tables.append(["Sample Variance", "Sample Standard Deviation",
                           "Sample Skewness", "Sample Kurtosis"])
        if self.percentiles:
            tables.append(self._PERC_NAMES)
        for names in tables:
            for n in names:
                out[n] = []

        for cs in frame.schema:
            out["Feature"].append(cs.name)
            arr = frame.column(cs.name)
            numeric = self._numeric_view(arr, cs)
            if self.counts:
                self._append(out, ["Count", "Unique Value Count",
                                   "Missing Value Count"],
                             self._counts(arr, cs))
            if self.basic:
                self._append(out, self._BASIC_NAMES,
                             self._quantiles(numeric, self._BASIC_Q))
            if self.sample:
                self._append(out, ["Sample Variance",
                                   "Sample Standard Deviation",
                                   "Sample Skewness", "Sample Kurtosis"],
                             self._moments(numeric))
            if self.percentiles:
                self._append(out, self._PERC_NAMES,
                             self._quantiles(numeric, self._PERC_Q))
        return Frame.from_dict(out)

    @staticmethod
    def _append(out, names, vals):
        for n, v in zip(names, vals):
            out[n].append(v)

    @staticmethod
    def _numeric_view(arr: np.ndarray, cs: ColumnSchema) -> Optional[np.ndarray]:
        if not cs.dtype.is_numeric or arr.ndim > 1:
            return None
        vals = arr.astype(np.float64)
        return vals[~np.isnan(vals)]

    @staticmethod
    def _counts(arr: np.ndarray, cs: ColumnSchema) -> List[float]:
        n = len(arr)
        if arr.dtype == np.object_:
            missing = sum(1 for v in arr if v is None)
            uniq = len({v for v in arr if v is not None})
        elif arr.ndim > 1:
            missing = int(np.isnan(arr).any(axis=1).sum())
            uniq = len({tuple(r) for r in arr})
        elif np.issubdtype(arr.dtype, np.floating):
            nan = np.isnan(arr)
            missing = int(nan.sum())
            uniq = len(np.unique(arr[~nan]))
        else:
            missing = 0
            uniq = len(np.unique(arr))
        return [float(n - missing), float(uniq), float(missing)]

    def _quantiles(self, numeric: Optional[np.ndarray], qs: List[float]) -> List[float]:
        if numeric is None or len(numeric) == 0:
            return [float("nan")] * len(qs)
        return [float(v) for v in np.quantile(numeric, qs)]

    @staticmethod
    def _moments(numeric: Optional[np.ndarray]) -> List[float]:
        if numeric is None or len(numeric) < 2:
            return [float("nan")] * 4
        n = len(numeric)
        mean = numeric.mean()
        d = numeric - mean
        m2 = float((d ** 2).sum())
        var = m2 / (n - 1)  # sample variance, Spark semantics
        std = float(np.sqrt(var))
        pop_std = float(np.sqrt(m2 / n))
        if pop_std == 0:
            skew = kurt = float("nan")
        else:
            # Spark's skewness/kurtosis are population-style (no bias correction)
            skew = float((d ** 3).mean() / pop_std ** 3)
            kurt = float((d ** 4).mean() / pop_std ** 4 - 3.0)
        return [var, std, skew, kurt]


@register_stage
class PartitionSample(Transformer):
    """head / random sample / assign-to-partition.

    Reference (``PartitionSample.scala:81-117``); its AssignToPartition mode
    is a broken stub — here it actually stamps a partition-index column.
    """

    mode = StringParam("mode", "sampling mode", "RandomSample",
                       domain=["RandomSample", "Head", "AssignToPartition"])
    rsMode = StringParam("rsMode", "random-sample sizing", "Percentage",
                         domain=["Percentage", "Absolute"])
    seed = IntParam("seed", "random seed", -1)
    percent = FloatParam("percent", "fraction of rows to keep", 0.01)
    count = IntParam("count", "absolute number of rows", 1000)
    newColName = StringParam("newColName", "partition column name", "Partition")
    numParts = IntParam("numParts", "partitions for AssignToPartition", 10)

    def transform(self, frame: Frame) -> Frame:
        mode = self.mode
        if mode == "Head":
            return self._head(frame, self.count)
        if mode == "RandomSample":
            total = frame.count()
            frac = self.percent if self.rsMode == "Percentage" \
                else min(1.0, self.count / max(total, 1))
            seed = self.seed if self.seed >= 0 else 0
            rng = np.random.default_rng(seed)
            # Bernoulli per row (Spark .sample semantics: approximate size)
            return frame.filter(
                lambda p: rng.random(len(p[frame.schema.names[0]])) < frac)
        # AssignToPartition
        seed = self.seed if self.seed >= 0 else 0
        rng = np.random.default_rng(seed)
        col = ColumnSchema(self.newColName, DType.INT32)
        return frame.with_column(
            col, lambda p: rng.integers(
                0, self.numParts, len(p[frame.schema.names[0]]),
                dtype=np.int32))

    @staticmethod
    def _head(frame: Frame, n: int) -> Frame:
        parts, taken = [], 0
        for p in frame.partitions:
            size = len(p[frame.schema.names[0]])
            take = min(n - taken, size)
            if take > 0:
                parts.append({k: v[:take] for k, v in p.items()})
                taken += take
            if taken >= n:
                break
        return Frame(frame.schema, parts or None)


@register_stage
class CheckpointData(Transformer):
    """Persist/unpersist stage (``CheckpointData.scala:31-70``).

    MEMORY_ONLY semantics are a no-op here — Frame partitions are already
    materialized host arrays. ``diskIncluded=True`` is the
    MEMORY_AND_DISK analogue done the out-of-core way: the frame is
    STAGED as memory-mapped chunks (``core/disk.py``) and a DiskFrame
    over them is returned, so everything downstream streams with page
    eviction instead of holding the arrays in RAM. Numeric/vector
    columns only (the DiskFrame contract); ``removeCheckpoint`` on a
    DiskFrame re-materializes it in memory.
    """

    diskIncluded = BooleanParam("diskIncluded", "also spill to disk", False)
    removeCheckpoint = BooleanParam("removeCheckpoint", "unpersist instead", False)
    checkpointDir = StringParam(
        "checkpointDir", "directory for diskIncluded chunk staging "
        "('' = a fresh temp dir)", "")

    def transform(self, frame: Frame) -> Frame:
        import shutil
        from mmlspark_tpu_torch.core.disk import DiskFrame, write_frame
        if self.removeCheckpoint:
            if isinstance(frame, DiskFrame):
                # np.array (not ascontiguousarray): a REAL writable copy —
                # a zero-copy view would still page from (and pin) the
                # chunk files this branch is about to reclaim
                out = Frame(frame.schema,
                            [{n: np.array(p[n])
                              for n in frame.schema.names}
                             for p in frame.partitions])
                staged = getattr(frame, "_checkpoint_dir", None)
                if staged:  # self-created staging only; user dirs are theirs
                    shutil.rmtree(staged, ignore_errors=True)
                return out
            return frame.unpersist()
        if not self.diskIncluded:
            return frame.cache()
        directory = self.checkpointDir or tempfile.mkdtemp(
            prefix="mmlspark_ckpt_")
        write_frame(frame, directory)
        out = DiskFrame.open(directory)
        if not self.checkpointDir:
            out._checkpoint_dir = directory  # removeCheckpoint reclaims it
        return out
