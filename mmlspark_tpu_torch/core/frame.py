"""Frame: a partitioned, columnar, host-resident dataset that streams to a device.

The PyTorch port's own copy of ``mmlspark_tpu/core/frame.py``: the
JVM-free re-expression of the Spark DataFrame surface the reference's ML
layer needs (select/withColumn/na.drop/cache/repartition). Partitions are
host-local dicts of numpy arrays; ops are eager per-partition. Device
hand-off happens via :meth:`Frame.batches`, whose contiguous numpy
minibatches become device tensors in one copy each — the equivalent of the
reference's broadcast + ``mapPartitions`` minibatch loop
(``cntk-model/src/main/scala/CNTKModel.scala:215-221``).

Storage conventions per DType:
  numeric  -> 1-D ndarray of the numpy dtype
  STRING   -> 1-D object ndarray of str (None for missing)
  VECTOR   -> 2-D ndarray (n_rows, dim); float32 canonical, uint8 permitted
              (the raw-bytes wire format: 1/4 the host->device traffic, cast
              on device). Storage dtype is UNIFORM across partitions —
              Frame.__init__ enforces it, so consumers that cast must cast
              (uint8 arithmetic wraps) but never see mixed batches.
  IMAGE    -> 1-D object ndarray of schema.ImageValue
  BINARY   -> 1-D object ndarray of bytes
  TOKENS   -> 1-D object ndarray of list[str]
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from mmlspark_tpu_torch.core.schema import ColumnSchema, DType, Schema, SchemaError

Partition = Dict[str, np.ndarray]


def _infer_dtype(arr: np.ndarray) -> Tuple[DType, Optional[int]]:
    if arr.ndim == 2:
        return DType.VECTOR, int(arr.shape[1])
    if arr.dtype == np.bool_:
        return DType.BOOL, None
    if np.issubdtype(arr.dtype, np.integer):
        return (DType.INT32 if arr.dtype.itemsize <= 4 else DType.INT64), None
    if np.issubdtype(arr.dtype, np.floating):
        return (DType.FLOAT32 if arr.dtype.itemsize <= 4 else DType.FLOAT64), None
    # object arrays: inspect first non-null
    for v in arr:
        if v is None:
            continue
        if isinstance(v, str):
            return DType.STRING, None
        if isinstance(v, (bool, np.bool_)):
            return DType.BOOL, None
        if isinstance(v, (int, float, np.number)):
            return DType.FLOAT64, None
        if isinstance(v, (bytes, bytearray)):
            return DType.BINARY, None
        if isinstance(v, list):
            return DType.TOKENS, None
        from mmlspark_tpu_torch.core.schema import ImageValue
        if isinstance(v, ImageValue):
            return DType.IMAGE, None
        if isinstance(v, np.ndarray):
            return DType.VECTOR, int(v.shape[0])
    return DType.STRING, None


def _normalize(values: Any, dtype: Optional[DType] = None) -> Tuple[np.ndarray, DType, Optional[int]]:
    """Coerce a python sequence / ndarray into canonical column storage."""
    if isinstance(values, np.ndarray) and values.dtype != np.object_:
        arr = values
    else:
        lst = list(values)
        if lst and isinstance(lst[0], np.ndarray) and dtype in (None, DType.VECTOR):
            all_u8 = all(isinstance(v, np.ndarray) and v.dtype == np.uint8
                         for v in lst)
            elem = np.uint8 if all_u8 else np.float32
            arr = np.stack([np.asarray(v, dtype=elem) for v in lst])
        else:
            numeric = (bool(lst)
                       and any(v is not None for v in lst)
                       and all(v is None or isinstance(v, (int, float, bool, np.number))
                               for v in lst))
            has_none = any(v is None for v in lst)
            try:
                if dtype is not None and dtype.is_numeric:
                    if has_none:  # missing numeric -> NaN (na_drop can remove it)
                        arr = np.asarray([np.nan if v is None else v for v in lst],
                                         dtype=np.float64)
                    else:
                        arr = np.asarray(lst, dtype=dtype.numpy_dtype)
                elif dtype is None and numeric:
                    if has_none:
                        arr = np.asarray([np.nan if v is None else v for v in lst],
                                         dtype=np.float64)
                    else:
                        arr = np.asarray(lst)
                else:
                    raise ValueError
            except (ValueError, TypeError):
                arr = np.empty(len(lst), dtype=np.object_)
                for i, v in enumerate(lst):
                    arr[i] = v
    if dtype is None:
        dtype, dim = _infer_dtype(arr)
    else:
        dim = int(arr.shape[1]) if arr.ndim == 2 else None
    if dtype == DType.VECTOR and arr.ndim == 2 and arr.dtype != np.float32:
        # uint8 vectors keep their storage dtype: the raw-bytes wire format
        # crosses host->device at 1/4 the fp32 size and consumers (TorchModel,
        # the fused preprocess) cast on device. Everything else stores as
        # the canonical float32.
        if arr.dtype != np.uint8:
            arr = arr.astype(np.float32)
    elif dtype.is_numeric and arr.dtype != dtype.numpy_dtype and arr.dtype != np.object_:
        if (np.issubdtype(arr.dtype, np.floating)
                and np.issubdtype(dtype.numpy_dtype, np.integer)
                and np.isnan(arr).any()):
            dtype = DType.FLOAT64  # NaN is unrepresentable in ints; stay float
            arr = arr.astype(np.float64)
        else:
            arr = arr.astype(dtype.numpy_dtype)
    return arr, dtype, dim


class Frame:
    """Partitioned columnar dataset. Immutable-by-convention: ops return new Frames."""

    def __init__(self, schema: Schema, partitions: List[Partition]):
        self.schema = schema
        # own the list (not its dicts): _unify_vector_dtypes may replace
        # entries copy-on-write without touching a caller-shared list
        self.partitions = list(partitions) if partitions else [
            {c.name: _empty_column(c) for c in schema}]
        # memo for multi-partition column() concatenations (partitions are
        # immutable-by-convention, so the gather never goes stale)
        self._column_cache: Dict[str, np.ndarray] = {}
        for part in self.partitions:
            lens = {len(part[c.name]) for c in schema}
            if len(lens) > 1:
                raise SchemaError(f"ragged partition: column lengths {lens}")
        self._unify_vector_dtypes()

    def _unify_vector_dtypes(self) -> None:
        """One storage dtype per VECTOR column across ALL partitions.

        uint8 survives only when every non-empty partition agrees (the
        raw-bytes wire format); any divergence — a per-partition
        ``with_column`` that produced float rows somewhere, a union with a
        float frame — canonicalizes the whole column to float32. Without
        this, a batch's dtype would depend on which partitions it spans and
        a device consumer would see mixed batches mid-stream. Empty
        partitions don't vote but are re-typed to match.
        """
        for c in self.schema:
            if c.dtype != DType.VECTOR:
                continue
            # Only dense 2-D ndarray storage participates: a VECTOR column
            # can also arrive as a 1-D object array or plain list
            # (list-of-lists input, duck-typed map_partitions output) which
            # astype cannot densify — those are left for the consumer-side
            # np.asarray, as before this pass existed.
            vals = [part[c.name] for part in self.partitions]
            dense_idx = [i for i, a in enumerate(vals)
                         if isinstance(a, np.ndarray) and a.ndim == 2
                         and a.dtype != np.object_]
            if not dense_idx:
                continue
            dts = {vals[i].dtype for i in dense_idx if len(vals[i])}
            if not dts:
                continue  # all-empty: keep dtypes (a filtered-to-empty
                # uint8 frame must not silently flip to float32)
            # uint8 survives only when EVERY partition is dense uint8;
            # object/ragged partitions break purity, so dense ones
            # canonicalize to float32
            target = (np.dtype(np.uint8)
                      if len(dense_idx) == len(vals)
                      and dts == {np.dtype(np.uint8)}
                      else np.dtype(np.float32))
            for i in dense_idx:
                if vals[i].dtype != target:
                    # copy-on-write: partition dicts may be shared with
                    # sibling frames that must keep their own storage
                    part = dict(self.partitions[i])
                    part[c.name] = vals[i].astype(target)
                    self.partitions[i] = part

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_dict(data: Dict[str, Any], num_partitions: int = 1,
                  schema: Optional[Schema] = None) -> "Frame":
        cols: Dict[str, np.ndarray] = {}
        schemas: List[ColumnSchema] = []
        for name, values in data.items():
            want = schema[name].dtype if schema is not None and name in schema else None
            arr, dtype, dim = _normalize(values, want)
            cols[name] = arr
            base = schema[name] if schema is not None and name in schema else None
            md = dict(base.metadata) if base else {}
            schemas.append(ColumnSchema(name, dtype, dim, md))
        n = len(next(iter(cols.values()))) if cols else 0
        frame = Frame(Schema(schemas), [cols])
        return frame.repartition(num_partitions) if num_partitions > 1 and n else frame

    @staticmethod
    def from_rows(rows: Sequence[Dict[str, Any]], num_partitions: int = 1) -> "Frame":
        if not rows:
            raise SchemaError("from_rows needs at least one row")
        names = list(rows[0].keys())
        return Frame.from_dict({n: [r[n] for r in rows] for n in names}, num_partitions)

    @staticmethod
    def concat(frames: Sequence["Frame"]) -> "Frame":
        if not frames:
            raise SchemaError("concat requires at least one frame")
        first = frames[0]
        for f in frames[1:]:
            if f.schema.names != first.schema.names:
                raise SchemaError(
                    f"concat schema mismatch: {f.schema.names} vs {first.schema.names}")
        parts = [p for f in frames for p in f.partitions]
        return Frame(first.schema, parts)

    # -- basic info --------------------------------------------------------
    @property
    def num_partitions(self) -> int:
        return len(self.partitions)

    def count(self) -> int:
        first = self.schema.names[0] if self.schema.names else None
        if first is None:
            return 0
        return sum(len(p[first]) for p in self.partitions)

    def __len__(self) -> int:
        return self.count()

    @property
    def columns(self) -> List[str]:
        return self.schema.names

    # -- column access -----------------------------------------------------
    def column(self, name: str) -> np.ndarray:
        """Concatenate one column across partitions (host-side collect).
        Multi-partition gathers are memoized, so per-epoch consumers
        (``shuffled_batches``) pay the concatenation once per frame."""
        self.schema[name]
        arrs = [p[name] for p in self.partitions]
        if len(arrs) == 1:
            return arrs[0]
        cached = self._column_cache.get(name)
        if cached is None:
            cached = self._column_cache[name] = np.concatenate(arrs, axis=0)
        return cached

    def collect(self) -> Dict[str, np.ndarray]:
        return {n: self.column(n) for n in self.schema.names}

    def head(self, n: int = 5) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for part in self.partitions:
            take = min(n - len(out), len(part[self.schema.names[0]]))
            for i in range(take):
                out.append({name: part[name][i] for name in self.schema.names})
            if len(out) >= n:
                break
        return out

    # -- relational ops ----------------------------------------------------
    def select(self, *names: str) -> "Frame":
        names = list(names[0]) if len(names) == 1 and isinstance(names[0], (list, tuple)) else list(names)
        schema = self.schema.select(names)
        parts = [{n: p[n] for n in names} for p in self.partitions]
        return Frame(schema, parts)

    def drop(self, *names: str) -> "Frame":
        keep = [n for n in self.schema.names if n not in set(names)]
        return self.select(*keep)

    def rename(self, mapping: Dict[str, str]) -> "Frame":
        schema = Schema([c.renamed(mapping.get(c.name, c.name)) for c in self.schema])
        parts = [{mapping.get(n, n): p[n] for n in self.schema.names}
                 for p in self.partitions]
        return Frame(schema, parts)

    def with_column(self, col: ColumnSchema,
                    fn: Callable[[Partition], np.ndarray]) -> "Frame":
        """Add/replace a column; ``fn`` maps a partition dict to the new array."""
        # Two passes: normalize every partition first, then unify on ONE
        # dtype — otherwise a NaN appearing in only one partition would leave
        # the schema disagreeing with the other partitions' arrays.
        normalized = [_normalize(fn(p), col.dtype) for p in self.partitions]
        actuals = {a for _, a, _ in normalized}
        final_dtype = col.dtype
        final_dim = col.dim
        if len(actuals) == 1:
            only = next(iter(actuals))
            if only != col.dtype:
                final_dtype = only
        elif actuals and all(a.is_numeric for a in actuals):
            final_dtype = DType.FLOAT64
        if col.dtype == DType.VECTOR:
            dims = {d for _, _, d in normalized if d is not None}
            if final_dim is None and len(dims) == 1:
                final_dim = next(iter(dims))
            elif len(dims) > 1:
                raise SchemaError(
                    f"column {col.name!r}: inconsistent vector dims {dims}")
        schema = self.schema.add(
            ColumnSchema(col.name, final_dtype, final_dim, col.metadata))
        parts = []
        for p, (arr, actual, _) in zip(self.partitions, normalized):
            if final_dtype.is_numeric and arr.dtype != final_dtype.numpy_dtype:
                if arr.dtype == np.object_:
                    raise SchemaError(
                        f"column {col.name!r}: declared {final_dtype.value} but "
                        "produced non-numeric values")
                arr = arr.astype(final_dtype.numpy_dtype)
            q = dict(p)
            q[col.name] = arr
            parts.append(q)
        return Frame(schema, parts)

    def with_column_values(self, col: ColumnSchema, values: Any) -> "Frame":
        """Add/replace a column from a full-length array, split across partitions."""
        arr, actual, dim = _normalize(values, col.dtype)
        if col.dtype == DType.VECTOR and col.dim is None and dim is not None:
            col = ColumnSchema(col.name, col.dtype, dim, col.metadata)
        elif actual != col.dtype:
            col = ColumnSchema(col.name, actual, dim, col.metadata)
        if len(arr) != self.count():
            raise SchemaError(f"column length {len(arr)} != frame length {self.count()}")
        schema = self.schema.add(col)
        parts, off = [], 0
        for p in self.partitions:
            n = len(p[self.schema.names[0]]) if self.schema.names else len(arr)
            q = dict(p)
            q[col.name] = arr[off:off + n]
            parts.append(q)
            off += n
        return Frame(schema, parts)

    def with_metadata(self, name: str, **meta) -> "Frame":
        return Frame(self.schema.add(self.schema[name].with_meta(**meta)),
                     self.partitions)

    def map_partitions(self, schema: Schema,
                       fn: Callable[[Partition], Partition]) -> "Frame":
        return Frame(schema, [fn(dict(p)) for p in self.partitions])

    def filter(self, mask_fn: Callable[[Partition], np.ndarray]) -> "Frame":
        parts = []
        for p in self.partitions:
            mask = np.asarray(mask_fn(p), dtype=bool)
            parts.append({n: p[n][mask] for n in self.schema.names})
        return Frame(self.schema, parts)

    def random_split(self, weights: Sequence[float],
                     seed: int = 0) -> List["Frame"]:
        """Split rows into disjoint Frames with expected proportions
        ``weights`` — Spark's ``DataFrame.randomSplit``, which the
        reference's benchmark harness uses for its 60/40 train/test split
        (``VerifyTrainClassifier.scala:548-551``). Seeded per-row uniforms
        against the cumulative normalized weights, so every row lands in
        exactly one split and the same seed reproduces the partition."""
        w = np.asarray(list(weights), np.float64)
        if len(w) < 2 or not np.all(w > 0):   # catches NaN too
            raise ValueError(f"weights must be >=2 positive values, got "
                             f"{list(weights)}")
        edges = np.r_[0.0, np.cumsum(w) / w.sum()]
        edges[-1] = 1.0 + 1e-9          # a u of exactly 1.0 still lands
        first = self.schema.names[0]
        us = [np.random.default_rng((int(seed), i)).uniform(
                  size=len(p[first]))
              for i, p in enumerate(self.partitions)]
        out = []
        for lo, hi in zip(edges[:-1], edges[1:]):
            parts = [{n: p[n][(u >= lo) & (u < hi)]
                      for n in self.schema.names}
                     for p, u in zip(self.partitions, us)]
            out.append(Frame(self.schema, parts))
        return out

    def na_drop(self, cols: Optional[Sequence[str]] = None) -> "Frame":
        """Drop rows with None/NaN in any of ``cols`` (default: all columns)."""
        cols = list(cols) if cols is not None else self.schema.names

        def mask(p: Partition) -> np.ndarray:
            n = len(p[self.schema.names[0]])
            keep = np.ones(n, dtype=bool)
            for c in cols:
                arr = p[c]
                if arr.dtype == np.object_:
                    keep &= np.array([v is not None for v in arr])
                elif np.issubdtype(arr.dtype, np.floating):
                    if arr.ndim == 2:
                        keep &= ~np.isnan(arr).any(axis=1)
                    else:
                        keep &= ~np.isnan(arr)
            return keep
        return self.filter(mask)

    def distinct_values(self, col: str) -> List[Any]:
        seen, out = set(), []
        for p in self.partitions:
            for v in p[col]:
                key = v.item() if isinstance(v, np.generic) else v
                if isinstance(key, float) and math.isnan(key):
                    key = "__nan__"
                if key not in seen:
                    seen.add(key)
                    out.append(v)
        return out

    def union(self, other: "Frame") -> "Frame":
        if other.schema.names != self.schema.names:
            raise SchemaError("union requires identical column names")
        return Frame(self.schema, self.partitions + other.partitions)

    # -- partitioning (reference pipeline-stages/Repartition.scala) --------
    def repartition(self, n: int) -> "Frame":
        if n <= 0:
            raise SchemaError("repartition requires n >= 1")
        cols = self.collect()
        total = self.count()
        bounds = np.linspace(0, total, n + 1).astype(int)
        parts = [{name: arr[bounds[i]:bounds[i + 1]] for name, arr in cols.items()}
                 for i in range(n)]
        return Frame(self.schema, parts)

    def coalesce(self, n: int) -> "Frame":
        if n >= self.num_partitions:
            return self
        groups = np.array_split(np.arange(self.num_partitions), n)
        parts = []
        for g in groups:
            sub = [self.partitions[i] for i in g]
            parts.append({name: np.concatenate([p[name] for p in sub], axis=0)
                          for name in self.schema.names})
        return Frame(self.schema, parts)

    def process_shard(self, index: Optional[int] = None,
                      count: Optional[int] = None,
                      block_rows: Optional[int] = None) -> "Frame":
        """This process's row shard for multi-process training.

        Each host keeps only the rows its devices will hold — the
        replacement for the reference's shared-filesystem hand-off where
        every MPI rank re-read the full dataset
        (``cntk-train/src/main/scala/DataConversion.scala:106-173``).
        Shards are balanced within one row/block.

        Default (``block_rows=None``): contiguous split, rows
        ``[i*n/P, (i+1)*n/P)`` — simplest, order-preserving.

        ``block_rows=b``: block-cyclic — process ``i`` keeps row blocks
        ``i, i+P, i+2P, ...`` of size ``b``.

        Defaults to this rank's share in an initialized
        ``torch.distributed`` process group (0 of 1 without one): its
        block on the data axes of the configured mesh and their count
        (``parallel/mesh.py::data_shard``), so ranks that differ only on
        ``tensor`` or ``seq`` hold the same rows; ``(rank, world)`` when
        no mesh is configured. Pass ``index``/``count`` to shard for
        another topology.
        """
        if index is None or count is None:
            from mmlspark_tpu_torch.parallel.mesh import data_shard
            mine, blocks = data_shard()
            index = mine if index is None else index
            count = blocks if count is None else count
        i, p = int(index), int(count)
        if not 0 <= i < p:
            raise SchemaError(f"process_shard index {i} outside count {p}")
        n = self.count()
        cols = self.collect()
        if block_rows is None:
            bounds = np.linspace(0, n, p + 1).astype(int)
            idx = np.arange(int(bounds[i]), int(bounds[i + 1]))
        else:
            if block_rows <= 0:
                raise SchemaError(f"block_rows must be positive, "
                                  f"got {block_rows}")
            idx = np.nonzero((np.arange(n) // block_rows) % p == i)[0]
        return Frame(self.schema,
                     [{name: arr[idx] for name, arr in cols.items()}])

    def cache(self) -> "Frame":
        """Partitions are already materialized host arrays; kept for API parity
        with the reference's CheckpointData persist (CheckpointData.scala:31-70)."""
        return self

    def unpersist(self) -> "Frame":
        return self

    # -- device streaming --------------------------------------------------
    # Subclass hooks for batches(): DiskFrame swaps the batch assembler for
    # a must-copy variant and evicts a chunk's pages once it is consumed.
    _cat_batch = staticmethod(lambda arrs: _cat(arrs))

    def _partition_consumed(self, p: Partition) -> None:
        pass

    def batches(self, batch_size: int, cols: Optional[Sequence[str]] = None,
                drop_remainder: bool = False) -> Iterator[Dict[str, np.ndarray]]:
        """Yield stacked numpy minibatches across partition boundaries.

        The streaming analogue of the reference's buffered minibatch iterator
        (``CNTKModel.scala:50-104``) minus the per-element JVM->native copy sin:
        slices here are contiguous ndarray views copied to the device whole.
        """
        cols = list(cols) if cols is not None else self.schema.names
        buf: Dict[str, List[np.ndarray]] = {c: [] for c in cols}
        buffered = 0
        for p in self.partitions:
            n = len(p[cols[0]]) if cols else 0
            off = 0
            while off < n:
                take = min(batch_size - buffered, n - off)
                for c in cols:
                    buf[c].append(p[c][off:off + take])
                buffered += take
                off += take
                if buffered == batch_size:
                    yield {c: self._cat_batch(buf[c]) for c in cols}
                    buf = {c: [] for c in cols}
                    buffered = 0
            self._partition_consumed(p)
        if buffered and not drop_remainder:
            yield {c: self._cat_batch(buf[c]) for c in cols}

    def shuffled_batches(self, batch_size: int, cols: Optional[Sequence[str]] = None,
                         rng: Optional[np.random.Generator] = None,
                         drop_remainder: bool = False
                         ) -> Iterator[Dict[str, np.ndarray]]:
        """Minibatches in a fresh global row permutation (one per call).

        SGD learners need this: sequential ``batches`` on label- or
        time-ordered data trains each step on a biased slice. Partitions are
        host-resident and the column gather is memoized on the frame, so
        per-epoch calls pay only the permutation plus per-batch fancy
        indexing. Pass a persistent ``rng`` for reproducibility; the default
        draws fresh OS entropy per call.
        """
        rng = rng if rng is not None else np.random.default_rng()
        cols = list(cols) if cols is not None else self.schema.names
        arrs = {c: self.column(c) for c in cols}
        n = self.count()
        perm = rng.permutation(n)
        end = n - n % batch_size if drop_remainder else n
        for off in range(0, end, batch_size):
            idx = perm[off:off + batch_size]
            yield {c: arrs[c][idx] for c in cols}

    def __repr__(self) -> str:
        cols = ", ".join(f"{c.name}:{c.dtype.value}" for c in self.schema)
        return f"Frame[{cols}] rows={self.count()} partitions={self.num_partitions}"


def _cat(arrs: List[np.ndarray]) -> np.ndarray:
    return arrs[0] if len(arrs) == 1 else np.concatenate(arrs, axis=0)


def _empty_column(c: ColumnSchema) -> np.ndarray:
    if c.dtype == DType.VECTOR:
        return np.zeros((0, c.dim or 0), dtype=np.float32)
    return np.zeros(0, dtype=c.dtype.numpy_dtype)
