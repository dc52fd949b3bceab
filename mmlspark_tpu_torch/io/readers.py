"""File readers: binary files, images, CSV — the ingestion layer.

The PyTorch port's copy of ``mmlspark_tpu/io/readers.py``, a
re-expression of the reference's readers
(``readers/src/main/scala/{Readers,BinaryFileReader,ImageReader}.scala``):

- ``read_binary_files(path, recursive, sample_ratio, inspect_zip, seed)``:
  recursive directory walk, seeded fractional file sampling (the
  reference's SamplePathFilter) and zip-entry streaming with the same
  seeded sampling (its ``ZipIterator``); ``list_binary_entries`` is the
  listing alone, which ``data.FileSource`` streams from;
- ``read_images`` / ``stream_images``: binary read + decode
  (``io/codecs.py``, the native codec first); undecodable files are
  dropped as in the reference (``ImageReader.scala:55-59``) with the drop
  count in the frame's column metadata and the ``data.decode_dropped``
  counter;
- ``read_csv`` with its column type inference (the tabular paths).

``process_shard=True`` keeps this rank's contiguous slice: the slice of
its block on the data axes of the configured mesh, ``(rank, world)``
without one, the whole list outside a process group
(``parallel/mesh.py::data_shard``, as ``Frame.process_shard`` does).
``read_parquet`` / ``write_parquet`` import pyarrow inside each call, as
the reference's do: where pyarrow is missing, only those calls raise
``ImportError``.
"""
from __future__ import annotations

import csv as _csv
import os
import random
import zipfile
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.core.schema import (
    ColumnSchema, DType, ImageValue, Schema,
)
from mmlspark_tpu_torch.io.codecs import decode_image
from mmlspark_tpu_torch.observability import metrics as obsmetrics
from mmlspark_tpu_torch.reliability.faults import fault_site


def _process_slice(items: List, process_shard: bool) -> List:
    """This rank's contiguous slice of a sorted work list (multi-process
    ingestion: every rank lists the same items and keeps its share, the
    share of its block on the data axes of the configured mesh:
    ``parallel/mesh.py::data_shard``)."""
    if not process_shard:
        return items
    from mmlspark_tpu_torch.parallel.mesh import data_shard
    i, p = data_shard()
    bounds = np.linspace(0, len(items), p + 1).astype(int)
    return items[bounds[i]:bounds[i + 1]]


def _list_files(path: str, recursive: bool) -> List[str]:
    if os.path.isfile(path):
        return [path]
    out = []
    if recursive:
        for root, _dirs, files in os.walk(path):
            out.extend(os.path.join(root, f) for f in sorted(files))
    else:
        for f in sorted(os.listdir(path)):
            full = os.path.join(path, f)
            if os.path.isfile(full):
                out.append(full)
    return sorted(out)


def _sample(items: List, ratio: float, seed: int) -> List:
    """Seeded fractional sampling (reference SamplePathFilter semantics:
    independent coin flip per item)."""
    if ratio >= 1.0:
        return items
    rng = random.Random(seed)
    return [x for x in items if rng.random() < ratio]


def list_binary_entries(path: str, recursive: bool = False,
                        sample_ratio: float = 1.0, inspect_zip: bool = True,
                        seed: int = 0,
                        process_shard: bool = False
                        ) -> List[Tuple[str, Optional[str]]]:
    """The deterministic entry LISTING under every binary reader: a list of
    ``(file_path, zip_entry_name_or_None)`` after the recursive walk, the
    seeded fractional sample, the zip-entry expansion, and the per-process
    contiguous slice. Pure metadata — no payload is read — so it doubles
    as the shard/cursor space for the streaming pipeline's ``FileSource``
    (``data/pipeline.py``): entry ``i`` here is record ``i`` there, and in
    ``iter_binary_entries``/``read_binary_files``.
    """
    if not 0.0 < sample_ratio <= 1.0:
        raise ValueError(f"sample_ratio must be in (0, 1], got {sample_ratio}")
    all_files = _list_files(path, recursive)
    # Zips are exempt from file-level sampling when inspected — their ENTRIES
    # are sampled instead (reference SamplePathFilter, HadoopUtils.scala:104:
    # `isZipFile(path) && inspectZip || random < sampleRatio`).
    zips = {f for f in all_files
            if inspect_zip and f.endswith(".zip") and zipfile.is_zipfile(f)}
    files = _process_slice(
        sorted(_sample([f for f in all_files if f not in zips],
                       sample_ratio, seed) + list(zips)), process_shard)
    entries: List[Tuple[str, Optional[str]]] = []
    for f in files:
        if f in zips:
            with zipfile.ZipFile(f) as z:
                names = [n for n in sorted(z.namelist())
                         if not n.endswith("/")]
                # zip entries are themselves subject to the sample ratio
                # (reference ZipIterator seeded sampling)
                entries.extend((f, n) for n in _sample(names, sample_ratio,
                                                       seed))
        else:
            entries.append((f, None))
    return entries


def iter_binary_entries(path: str, recursive: bool = False,
                        sample_ratio: float = 1.0, inspect_zip: bool = True,
                        seed: int = 0, process_shard: bool = False):
    """Lazily yield ``(path, bytes)`` one entry at a time.

    The streaming core under both the eager Frame readers and the chunked
    ``stream_*`` APIs: only the file LISTING is materialized up front; each
    blob is read (and each zip opened) as the consumer pulls it, so a
    terabyte image corpus streams through O(one file) of memory.

    ``process_shard=True`` keeps only this process's contiguous slice of
    the sorted file list (a zip counts as one file; its entries stay
    together) — per-host ingestion for multi-process training.
    """
    entries = list_binary_entries(path, recursive, sample_ratio, inspect_zip,
                                  seed, process_shard)
    zf_path: Optional[str] = None
    zf: Optional[zipfile.ZipFile] = None
    try:
        for f, inner in entries:
            if inner is None:
                with open(f, "rb") as fh:
                    yield f, fault_site("readers.read", payload=fh.read())
            else:
                if zf_path != f:  # entries of one zip are contiguous
                    if zf is not None:
                        zf.close()
                    zf_path, zf = f, zipfile.ZipFile(f)
                yield f"{f}/{inner}", fault_site("readers.read",
                                                 payload=zf.read(inner))
    finally:
        if zf is not None:
            zf.close()


def stream_binary_files(path: str, recursive: bool = False,
                        sample_ratio: float = 1.0, inspect_zip: bool = True,
                        seed: int = 0, chunk_rows: int = 256):
    """Yield host-batch dicts ``{"path", "bytes"}`` of <= chunk_rows entries.

    The lazy counterpart of :func:`read_binary_files` for corpora that do
    not fit in memory — chunks feed DevicePrefetcher / DistributedTrainer
    directly, replacing the reference's write-to-shared-FS hand-off
    (``CNTKLearner.scala:93-125``) with bounded-memory streaming.
    """
    paths: List[str] = []
    blobs: List[bytes] = []
    for p, b in iter_binary_entries(path, recursive, sample_ratio,
                                    inspect_zip, seed):
        paths.append(p)
        blobs.append(b)
        if len(paths) >= chunk_rows:
            yield {"path": _object_array(paths), "bytes": _object_array(blobs)}
            paths, blobs = [], []
    if paths:
        yield {"path": _object_array(paths), "bytes": _object_array(blobs)}


def stream_images(path: str, recursive: bool = False,
                  sample_ratio: float = 1.0, inspect_zip: bool = True,
                  seed: int = 0, chunk_rows: int = 256,
                  decode_threads: int = 8):
    """Yield ``{"path", "image"}`` chunks of decoded images, lazily.

    Decode runs per chunk through the native threaded pool; undecodable
    entries are dropped within their chunk (``ImageReader.scala:55-59``
    semantics). Memory high-water mark is one chunk of decoded images.
    """
    for chunk in stream_binary_files(path, recursive, sample_ratio,
                                     inspect_zip, seed, chunk_rows):
        decoded = _decode_blobs(list(chunk["bytes"]),
                                n_threads=decode_threads)
        images, keep = [], []
        for pth, arr in zip(chunk["path"], decoded):
            if arr is not None:
                images.append(ImageValue(path=pth, data=arr))
                keep.append(pth)
        if len(images) < len(decoded):
            obsmetrics.counter("data.decode_dropped").inc(
                len(decoded) - len(images))
        if images:
            yield {"path": _object_array(keep), "image": _object_array(images)}


def _object_array(values: Sequence) -> np.ndarray:
    arr = np.empty(len(values), dtype=np.object_)
    for i, v in enumerate(values):
        arr[i] = v
    return arr


def read_binary_files(path: str, recursive: bool = False,
                      sample_ratio: float = 1.0, inspect_zip: bool = True,
                      seed: int = 0, num_partitions: int = 1,
                      process_shard: bool = False) -> Frame:
    """Frame with (path, bytes) columns — reference BinaryFileSchema.
    ``process_shard=True``: this host reads only its slice of the file list."""
    paths: List[str] = []
    blobs: List[bytes] = []
    for p, b in iter_binary_entries(path, recursive, sample_ratio,
                                    inspect_zip, seed, process_shard):
        paths.append(p)
        blobs.append(b)
    frame = Frame.from_dict({"path": paths, "bytes": blobs},
                            schema=Schema([
                                ColumnSchema("path", DType.STRING),
                                ColumnSchema("bytes", DType.BINARY)]))
    return frame.repartition(num_partitions) if num_partitions > 1 else frame


def _decode_blobs(blobs: Sequence[bytes],
                  n_threads: int = 8) -> List[Optional[np.ndarray]]:
    """Batch decode: native threaded pool (JPEG/PNG) with per-blob python
    fallback for the formats/failures it does not cover (e.g. BMP)."""
    try:
        from mmlspark_tpu_torch.utils.native_loader import (
            native_available, native_decode_batch)
        native = native_available()
    except Exception:
        native = False
    results: List[Optional[np.ndarray]] = [None] * len(blobs)
    if native:
        results = native_decode_batch(list(blobs), n_threads=n_threads)
    for i, r in enumerate(results):
        if r is None:
            results[i] = decode_image(blobs[i])
    return results


def read_images(path: str, recursive: bool = False, sample_ratio: float = 1.0,
                inspect_zip: bool = True, seed: int = 0,
                num_partitions: int = 1, decode_threads: int = 8,
                process_shard: bool = False) -> Frame:
    """Frame with one IMAGE column named 'image'; undecodable files dropped.
    ``process_shard=True``: this host reads/decodes only its file slice."""
    binary = read_binary_files(path, recursive, sample_ratio, inspect_zip,
                               seed, num_partitions, process_shard)
    dropped = 0
    parts = []
    for p in binary.partitions:
        images, keep_paths = [], []
        decoded = _decode_blobs(list(p["bytes"]), n_threads=decode_threads)
        for pth, arr in zip(p["path"], decoded):
            if arr is None:
                dropped += 1
                continue
            images.append(ImageValue(path=pth, data=arr))
            keep_paths.append(pth)
        parts.append({"path": _object_array(keep_paths),
                      "image": _object_array(images)})
    if dropped:
        # drops are rare by construction: unconditional cold counter, so
        # the loss shows in run reports even with hot-path metrics off
        obsmetrics.counter("data.decode_dropped").inc(dropped)
    schema = Schema([
        ColumnSchema("path", DType.STRING),
        ColumnSchema("image", DType.IMAGE,
                     metadata={"dropped_undecodable": dropped}),
    ])
    return Frame(schema, parts)


def read_csv(path: str, header: bool = True, num_partitions: int = 1,
             infer_types: bool = True, process_shard: bool = False) -> Frame:
    """Small CSV reader for the tabular paths (the reference leaned on
    spark.read.csv; this covers the benchmark/AutoML datasets).
    ``process_shard=True``: keep only this process's contiguous row slice
    (single-file format — every process parses, then keeps its share)."""
    with open(path, newline="") as f:
        rows = list(_csv.reader(f))
    if not rows:
        raise ValueError(f"empty csv: {path}")
    names = rows[0] if header else [f"c{i}" for i in range(len(rows[0]))]
    data_rows = rows[1:] if header else rows
    cols: dict = {n: [] for n in names}
    for r in data_rows:
        for n, v in zip(names, r):
            cols[n].append(v)
    if infer_types:
        # Types are inferred from the FULL row set BEFORE the per-process
        # slice: every process parses the whole file anyway, and slicing
        # first would let processes disagree on a column's dtype
        # (int-looking first half vs fractional second half).
        for n, vals in cols.items():
            cols[n] = _infer_csv_column(vals)
    if process_shard:
        cols = {n: _process_slice(vals, True) for n, vals in cols.items()}
    return Frame.from_dict(cols, num_partitions=num_partitions)


def read_parquet(path: str, columns: Optional[Sequence[str]] = None,
                 num_partitions: int = 1,
                 process_shard: bool = False) -> Frame:
    """Parquet ingestion — Spark's native storage format, so this is the
    highest-parity on-ramp for data produced by the reference's world
    (``spark.read.parquet``). ``path`` is a file or a directory of part
    files; ``process_shard=True`` keeps this rank's slice of the sorted
    part-file list (multi-file datasets) for multi-process training, or of
    the rows of a single file.

    Column mapping: numeric/bool -> numeric columns; string -> STRING;
    binary -> BINARY; list<number> with uniform lengths -> VECTOR;
    list<string> -> TOKENS.
    """
    import pyarrow as pa
    import pyarrow.parquet as pq
    cols = list(columns) if columns else None
    if os.path.isdir(path) and process_shard:
        # per-rank file sharding needs the explicit part list (recursive:
        # hive-style key=value subdirectories keep their files)
        files = sorted(
            os.path.join(r, f) for r, _d, fs in os.walk(path)
            for f in fs if f.endswith((".parquet", ".pq")))
        if not files:
            raise ValueError(f"no parquet part files under {path}")
        sliced = _process_slice(files, True)
        if not sliced:
            # legitimately empty shard (more ranks than files): an empty
            # frame with the REAL schema, from a zero-row slice of part 0
            table = pq.read_table(files[0], columns=cols).slice(0, 0)
        else:
            table = pa.concat_tables(
                [pq.read_table(f, columns=cols) for f in sliced])
    else:
        # pyarrow natively reads files AND directories (incl. hive layout)
        table = pq.read_table(path, columns=cols)
    data: dict = {}
    for name in table.column_names:
        data[name] = _from_arrow(name, table.column(name))
    frame = Frame.from_dict(data)
    if not os.path.isdir(path) and process_shard:
        frame = frame.process_shard()  # single file: shard rows instead
    return (frame.repartition(num_partitions)
            if num_partitions > 1 and frame.count() else frame)


def _from_arrow(name: str, col) -> Any:
    """Arrow column -> Frame column storage, dispatched on the Arrow TYPE
    (never sniffed from values — null/empty rows must not change a
    column's meaning)."""
    import pyarrow as pa
    typ = col.type
    if pa.types.is_floating(typ) or pa.types.is_integer(typ) \
            or pa.types.is_boolean(typ):
        return col.to_numpy(zero_copy_only=False)
    if pa.types.is_list(typ) or pa.types.is_fixed_size_list(typ) \
            or pa.types.is_large_list(typ):
        vt = typ.value_type
        if pa.types.is_string(vt) or pa.types.is_large_string(vt):
            return [list(r) if r is not None else None
                    for r in col.to_pylist()]          # TOKENS
        rows = col.to_pylist()
        if not rows:
            width = typ.list_size if pa.types.is_fixed_size_list(typ) else 0
            return np.zeros((0, width), np.float32)     # empty VECTOR
        lens = {len(r) for r in rows if r is not None}
        if len(lens) == 1 and all(r is not None for r in rows):
            return np.asarray(rows, np.float32)         # uniform -> VECTOR
        # Frame has no ragged-numeric column type; refusing beats the
        # silent corruption of routing numbers through TOKENS
        raise ValueError(
            f"column {name!r} is a ragged or null-bearing numeric list "
            "(lengths {}); pad/clean it to uniform vectors first".format(
                sorted(lens)))
    return col.to_pylist()  # strings, binary, nulls -> object column


def write_parquet(frame: Frame, path: str) -> str:
    """Persist a Frame as one parquet file (VECTOR -> list<float>,
    TOKENS -> list<string>; IMAGE columns are not representable — drop or
    encode them first)."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    arrays, names = [], []
    for c in frame.schema:
        vals = frame.column(c.name)
        if c.dtype == DType.IMAGE:
            raise ValueError(
                f"column {c.name!r} is an IMAGE column; encode or drop it "
                "before write_parquet")
        if c.dtype == DType.VECTOR:
            arr = pa.array([None if v is None else [float(x) for x in v]
                            for v in vals])
        elif c.dtype == DType.TOKENS:
            arr = pa.array([None if v is None else [str(t) for t in v]
                            for v in vals])
        else:
            arr = pa.array(vals.tolist()  # lint: allow-sync (numpy column)
                           if isinstance(vals, np.ndarray) else list(vals))
        arrays.append(arr)
        names.append(c.name)
    pq.write_table(pa.table(arrays, names=names), path)
    return path


def _infer_csv_column(vals: List[str]):
    def try_parse(cast):
        out = []
        for v in vals:
            if v == "" or v is None:
                out.append(None)
            else:
                out.append(cast(v))
        return out
    try:
        ints = try_parse(int)
        return ints
    except ValueError:
        pass
    try:
        return try_parse(float)
    except ValueError:
        pass
    return [None if v == "" else v for v in vals]
