"""DiskFrame: a bigger-than-memory Frame backed by memory-mapped chunks.

The PyTorch port's copy of ``mmlspark_tpu/core/disk.py``, with the same
on-disk layout, so either package opens the other's directory.

The reference inherited out-of-core datasets from Spark (L0): a DataFrame's
partitions lived on disk/HDFS and streamed through executors. This is the
single-host equivalent: a Frame whose partitions are directories
of per-column ``.npy`` chunks opened with ``mmap_mode='r'`` — touching a
batch faults in only that batch's pages, the OS evicts cold pages, and the
training loop's working set stays O(chunk) regardless of dataset size.

Layout on disk::

    <dir>/schema.json                 column schemas + chunk row counts
    <dir>/chunk00000/<column>.npy     one plain .npy per column per chunk

Write side: :func:`write_frame` accepts an in-memory Frame OR an iterator
of host-batch dicts (e.g. a featurize pipeline draining
``stream_binary_files``), so corpora larger than RAM can be STAGED without
ever being resident. Numeric/vector columns only — object columns (strings,
images) have no mmap representation; featurize first.

Read side: :meth:`DiskFrame.open` returns a Frame whose ``batches`` /
``_streaming_moments`` consumers work unchanged. ``shuffled_batches`` is
overridden with a bounded-memory two-level shuffle (chunk order, then rows
within a window of chunks) — epoch order is still seeded/deterministic but
is NOT the global uniform permutation an in-memory Frame draws; that is the
out-of-core tradeoff (the same one Spark made: shuffle within partition
granularity).

DeepClassifier composes with this out of the box: the DeviceEpochCache
budget check sees the true row count via shape stand-ins and declines
over-budget epochs WITHOUT materializing anything, falling back to the
streaming path, which pulls shuffled host batches through this class.
Exception: ``validationSplit`` would have to materialize the frame, so it
refuses a DiskFrame — stage separate train/val DiskFrame directories
instead.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Mapping, Optional, Sequence

import numpy as np

from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.core.schema import ColumnSchema, DType, Schema, SchemaError

_SCHEMA_FILE = "schema.json"


def _cat_copy(arrs: List[np.ndarray]) -> np.ndarray:
    """Concatenate into a REAL in-memory array. Unlike Frame's `_cat`, the
    single-element case still copies — a view into a released mmap would
    silently re-fault (and re-retain) the evicted pages downstream."""
    if len(arrs) == 1:
        return np.array(arrs[0])
    return np.concatenate(arrs, axis=0)


class _LazyPartition(Mapping):
    """Dict-like partition whose column arrays are mmap-opened on access."""

    def __init__(self, directory: str, names: Sequence[str], rows: int):
        self._dir = directory
        self._names = list(names)
        self._rows = rows
        self._open: Dict[str, np.ndarray] = {}

    def __getitem__(self, name: str) -> np.ndarray:
        arr = self._open.get(name)
        if arr is None:
            if name not in self._names:
                raise KeyError(name)
            arr = np.load(os.path.join(self._dir, f"{name}.npy"),
                          mmap_mode="r")
            self._open[name] = arr
        return arr

    def __iter__(self) -> Iterator[str]:
        return iter(self._names)

    def __len__(self) -> int:
        return len(self._names)

    def keys(self):
        return list(self._names)

    def release(self) -> None:
        """Evict this chunk's resident pages (madvise DONTNEED). The
        mapping stays valid — later access re-faults from disk — so the
        epoch's high-water resident set is the sliding window, not the
        whole file (without this, a full pass would look like the entire
        dataset is 'in memory' to RSS accounting even though the pages are
        reclaimable page cache)."""
        import mmap as _mmap
        for arr in self._open.values():
            mm = getattr(arr, "_mmap", None)
            if mm is not None:
                try:
                    mm.madvise(_mmap.MADV_DONTNEED)
                except (AttributeError, ValueError, OSError):
                    pass  # platform without madvise: pages stay cached


def _check_columns(schema: Schema) -> None:
    bad = [c.name for c in schema
           if c.dtype not in (DType.VECTOR, DType.FLOAT32, DType.FLOAT64,
                              DType.INT32, DType.INT64, DType.BOOL)]
    if bad:
        raise SchemaError(
            f"DiskFrame supports numeric/vector columns only; featurize "
            f"first (object columns: {bad})")


def write_frame(source, directory: str, rows_per_chunk: int = 65536,
                schema: Optional[Schema] = None) -> str:
    """Stage ``source`` (a Frame, or an iterator of host-batch dicts) as a
    DiskFrame directory. Streaming sources never materialize more than one
    chunk of rows; an input Frame streams through ``batches``."""
    if isinstance(source, Frame):
        schema = source.schema
        batches = source.batches(rows_per_chunk)
    else:
        if schema is None:
            raise SchemaError(
                "write_frame(iterator, ...) requires an explicit schema")
        batches = iter(source)
    _check_columns(schema)
    os.makedirs(directory, exist_ok=True)
    chunk_rows: List[int] = []
    buf: Optional[Dict[str, List[np.ndarray]]] = None
    buffered = 0

    def flush(cols: Dict[str, np.ndarray]) -> None:
        sub = os.path.join(directory, f"chunk{len(chunk_rows):05d}")
        os.makedirs(sub, exist_ok=True)
        n = None
        for name, arr in cols.items():
            arr = np.ascontiguousarray(arr)
            if arr.dtype == np.object_:
                raise SchemaError(f"column {name!r} is not mmap-able")
            np.save(os.path.join(sub, f"{name}.npy"), arr,
                    allow_pickle=False)
            n = len(arr) if n is None else n
        chunk_rows.append(int(n or 0))

    # VECTOR storage dtype is decided ONCE per column — from its first
    # batch — not per batch: a streaming source mixing uint8 and float
    # batches must not write mixed-dtype chunks (DiskFrame.open bypasses
    # Frame._unify_vector_dtypes, so mixed chunks would hand consumers
    # batches of another dtype mid-stream). A later uint8 batch in a float column is
    # promoted; a later float batch in a uint8 column raises — silent
    # uint8 quantization of real values is never acceptable.
    vector_dtypes: Dict[str, np.dtype] = {}

    def cast(name: str, arr: np.ndarray) -> np.ndarray:
        """Pin every chunk to ONE storage dtype per column (the invariant
        Frame.__init__._unify_vector_dtypes enforces for in-memory frames;
        mixed chunks would change a consumer's batch dtype mid-stream)."""
        col = schema[name]
        if col.dtype == DType.VECTOR:
            want = vector_dtypes.setdefault(
                name, np.dtype(np.uint8 if arr.dtype == np.uint8
                               else np.float32))
            if want == np.uint8 and arr.dtype != np.uint8:
                raise SchemaError(
                    f"column {name!r} stored as uint8 (from its first "
                    f"batch) but a later batch has dtype {arr.dtype}; "
                    f"cast the source to one dtype before write_frame")
            return arr if arr.dtype == want else arr.astype(want)
        want = col.dtype.numpy_dtype
        return arr if arr.dtype == want else arr.astype(want)

    for hb in batches:
        if set(hb) != set(schema.names):
            raise SchemaError(
                f"batch columns {sorted(hb)} != schema {schema.names}")
        hb = {k: cast(k, np.asarray(v)) for k, v in hb.items()}
        lens = {k: len(v) for k, v in hb.items()}
        if len(set(lens.values())) > 1:
            raise SchemaError(f"ragged batch: column lengths {lens}")
        n = len(next(iter(hb.values())))
        if buf is None:
            buf = {k: [] for k in hb}
        for k, v in hb.items():
            buf[k].append(v)
        buffered += n
        while buffered >= rows_per_chunk:
            cat = {k: np.concatenate(v) if len(v) > 1 else v[0]
                   for k, v in buf.items()}
            flush({k: v[:rows_per_chunk] for k, v in cat.items()})
            buf = {k: [v[rows_per_chunk:]] for k, v in cat.items()}
            buffered -= rows_per_chunk
    if buffered:
        flush({k: np.concatenate(v) if len(v) > 1 else v[0]
               for k, v in buf.items()})
    meta = {"columns": [c.to_json() for c in schema],
            "chunk_rows": chunk_rows}
    with open(os.path.join(directory, _SCHEMA_FILE), "w") as f:
        json.dump(meta, f)
    return directory


class DiskFrame(Frame):
    """Frame over memory-mapped chunk partitions (see module docstring)."""

    # consumers that would otherwise materialize the whole frame (e.g.
    # DeepClassifier's validationSplit) check this and refuse
    _out_of_core = True

    @staticmethod
    def open(directory: str) -> "DiskFrame":
        with open(os.path.join(directory, _SCHEMA_FILE)) as f:
            meta = json.load(f)
        schema = Schema([ColumnSchema.from_json(d) for d in meta["columns"]])
        parts = [
            _LazyPartition(os.path.join(directory, f"chunk{i:05d}"),
                           schema.names, rows)
            for i, rows in enumerate(meta["chunk_rows"])]
        frame = DiskFrame.__new__(DiskFrame)
        # bypass Frame.__init__'s eager ragged-check (it would open every
        # chunk's memmaps up front); chunk lengths were recorded at write
        frame.schema = schema
        frame.partitions = parts
        frame._column_cache = {}
        return frame

    def count(self) -> int:
        return sum(p._rows for p in self.partitions)

    # Frame.batches drives the loop; these hooks add the out-of-core
    # behavior: batches must be REAL arrays (not views into evictable
    # mmaps), and a chunk's pages evict once it is fully consumed.
    _cat_batch = staticmethod(_cat_copy)

    def _partition_consumed(self, p) -> None:
        p.release()

    def shuffled_batches(self, batch_size: int,
                         cols: Optional[Sequence[str]] = None,
                         rng: Optional[np.random.Generator] = None,
                         drop_remainder: bool = False,
                         window_chunks: int = 4
                         ) -> Iterator[Dict[str, np.ndarray]]:
        """Bounded-memory two-level shuffle: chunk order is permuted, then
        rows are permuted WITHIN a sliding window of ``window_chunks``
        chunks — memory stays O(window), order is seeded-deterministic.
        Not the global uniform permutation of an in-memory Frame (the
        Spark-era tradeoff, made explicit)."""
        rng = rng if rng is not None else np.random.default_rng()
        cols = list(cols) if cols is not None else self.schema.names
        order = rng.permutation(len(self.partitions))
        buf: Dict[str, List[np.ndarray]] = {c: [] for c in cols}
        pending: List[_LazyPartition] = []
        held = 0

        def drain(final: bool):
            nonlocal buf, held
            cat = {c: _cat_copy(buf[c]) for c in cols}
            for p in pending:  # window copied out: evict the chunk pages
                p.release()
            pending.clear()
            n = len(cat[cols[0]])
            perm = rng.permutation(n)
            end = n if final else n - n % batch_size
            for off in range(0, end, batch_size):
                idx = perm[off:off + batch_size]
                if len(idx) < batch_size and (drop_remainder or not final):
                    break
                yield {c: cat[c][idx] for c in cols}
            tail = perm[end:]
            buf = {c: [cat[c][tail]] for c in cols}
            held = len(tail)

        for pi in order:
            p = self.partitions[pi]
            for c in cols:
                buf[c].append(p[c])
            pending.append(p)
            held += p._rows
            if len(pending) >= window_chunks:
                yield from drain(final=False)
        if held:
            yield from drain(final=True)
