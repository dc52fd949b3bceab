"""Composable streaming input pipeline: sharded, shuffled, resumable.

The PyTorch port's copy of ``mmlspark_tpu/data/pipeline.py``; its
``state_dict()`` dicts are key-for-key the JAX package's, so a snapshot
taken by either package resumes in the other. Host code only: the
terminal :meth:`Dataset.to_device_iterator` hands batches to the trainer's
``put_batch``, which copies them to the card.

The tf.data/Grain-style counterpart of the reference's Spark-partition
ingestion (``Readers.scala``/``BinaryFileReader``): instead of
materializing a whole corpus into a host ``Frame`` before training
(``io.readers.read_images``), a ``Dataset`` describes a stream —

- :class:`FileSource` — deterministic per-host file sharding over the
  ``io.readers`` walk/sample/zip listing (every host lists the same
  files, reads only its contiguous slice);
- :class:`ShuffleBuffer` — seeded windowed shuffle (block permutation;
  the seed folds in the epoch and the block index, so order is a pure
  function of ``(seed, epoch, position)``);
- :class:`ParallelDecode` — a bounded worker pool running ``io.codecs``
  image decode (or any record function) OFF the consumer thread, yielding
  results in submission order; undecodable records drop, counted in the
  ``data.decode_dropped`` metric;
- :class:`Batcher` — fixed-size host batches with ``drop``/``pad``/
  ``keep`` remainder policies (``pad`` zero-fills and masks via a
  ``weight`` column — ``DistributedTrainer``'s pad-and-mask contract),
  plus a ``multi_hot`` pad policy for RAGGED id-list columns (recommender
  sparse features): each record's variable-length id list pads/truncates
  to a fixed slot width with pad id 0 and a per-slot weight mask;
- :meth:`Dataset.to_device_iterator` — the terminal stage: the same
  :class:`~mmlspark_tpu_torch.data.prefetch.DevicePrefetcher` the trainer
  uses.

Resumability is the design center: every stage's iterator carries explicit
state (``state_dict()`` / ``load_state_dict()`` — epoch, file cursor,
shuffle block index, batch boundary), the dicts are JSON-serializable, and
the contract is *consumed-prefix equivalence*: restoring a snapshot yields
exactly the records an uninterrupted iterator would have yielded after the
snapshot point, bit-for-bit. ``TrainCheckpointer.put_data_state`` persists
these snapshots next to the model checkpoints and
``ResilientTrainLoop.run_dataset`` resumes mid-epoch from them.

Fault sites: ``data.list`` (before the listing), ``data.shuffle`` (before
each block permutes), ``data.decode`` (before each record is handed to the
pool) — plus ``readers.read`` on every blob payload, shared with the eager
readers.
"""
from __future__ import annotations

import random
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from mmlspark_tpu_torch.data.prefetch import DevicePrefetcher
from mmlspark_tpu_torch.observability import events as obsevents
from mmlspark_tpu_torch.observability import metrics as obsmetrics
from mmlspark_tpu_torch.reliability import watchdog as _watchdog
from mmlspark_tpu_torch.reliability.faults import fault_site
from mmlspark_tpu_torch.utils import config as mmlconfig

Record = Dict[str, Any]


class PipelineIterator:
    """One stage's stateful iterator.

    ``state_dict()`` captures everything CONSUMED so far — never in-flight
    work (a parallel decode in progress, a half-assembled batch). Restoring
    it re-pulls the uncommitted tail from upstream and replays it through
    the same deterministic transforms, so the resumed stream is
    bit-identical to the uninterrupted one from the snapshot point on.
    """

    def __iter__(self) -> "PipelineIterator":
        return self

    def __next__(self) -> Any:
        raise NotImplementedError

    def state_dict(self) -> Dict[str, Any]:
        raise NotImplementedError

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        """Release stage resources (decode pools, zip handles). Idempotent."""

    def __enter__(self) -> "PipelineIterator":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False


class Dataset:
    """Declarative description of a streaming input pipeline.

    A ``Dataset`` is cheap and reusable: ``iter(epoch)`` builds a fresh
    :class:`PipelineIterator` chain each call (epoch folds into shuffle
    seeds). The fluent builders mirror the stage classes::

        ds = (FileSource("/data/flowers", recursive=True, process_shard=True)
              .shuffle(window=1024, seed=7)
              .decode()
              .batch(256, remainder="drop"))
        for host_batch in ds:                 # host-side iteration
            ...
        trainer.fit(state, ds)                # or hand it to the trainer

    ``DistributedTrainer.fit`` accepts a Dataset anywhere an iterable of
    host batches is accepted.
    """

    def iter(self, epoch: int = 0) -> PipelineIterator:
        raise NotImplementedError

    def __iter__(self) -> PipelineIterator:
        return self.iter(0)

    def shuffle(self, window: Optional[int] = None,
                seed: int = 0) -> "ShuffleBuffer":
        return ShuffleBuffer(self, window=window, seed=seed)

    def decode(self, fn: Optional[Callable[[Record], Optional[Record]]] = None,
               workers: Optional[int] = None,
               chunk: int = 16) -> "ParallelDecode":
        return ParallelDecode(self, fn=fn, workers=workers, chunk=chunk)

    def map(self, fn: Callable[[Any], Any]) -> "MapRecords":
        return MapRecords(self, fn)

    def batch(self, size: int, remainder: str = "drop",
              multi_hot: Optional[Dict[str, int]] = None) -> "Batcher":
        return Batcher(self, size, remainder=remainder, multi_hot=multi_hot)

    def repeat(self, epochs: Optional[int] = None) -> "Repeat":
        return Repeat(self, epochs=epochs)

    def to_device_iterator(self, put: Callable[[Record], Any],
                           depth: Optional[int] = None,
                           epoch: int = 0) -> DevicePrefetcher:
        """Terminal stage: a DevicePrefetcher committing each host batch via
        ``put`` (usually ``trainer.put_batch``). Depth resolves
        ``data.prefetch_depth`` (0 = fall back to
        ``runtime.prefetch_depth``). NOTE the prefetcher runs AHEAD of the
        consumer, so for checkpointable mid-epoch state drive the raw
        ``iter()`` synchronously instead (``ResilientTrainLoop.run_dataset``
        does)."""
        if depth is None:
            configured = int(mmlconfig.get("data.prefetch_depth"))
            depth = configured if configured > 0 else None
        return DevicePrefetcher(self.iter(epoch), put, depth=depth)


# -- source ------------------------------------------------------------------

class FileSource(Dataset):
    """Deterministic file/zip-entry source over the ``io.readers`` walk.

    The listing (recursive walk, seeded fractional sampling, zip-entry
    expansion, and with ``process_shard`` the contiguous slice of this
    rank's block on the mesh's data axes) is exactly
    ``io.readers.list_binary_entries`` — the same files in the same order
    as ``read_binary_files``/``read_images``, so a streamed epoch is
    bit-comparable to the materialized-Frame path. Records are
    ``{"path": str, "bytes": bytes}``; payloads read lazily, one entry at
    a time.
    """

    def __init__(self, path: str, recursive: bool = False,
                 sample_ratio: float = 1.0, inspect_zip: bool = True,
                 seed: int = 0, process_shard: bool = False):
        if not 0.0 < sample_ratio <= 1.0:
            raise ValueError(
                f"sample_ratio must be in (0, 1], got {sample_ratio}")
        self.path = path
        self.recursive = recursive
        self.sample_ratio = sample_ratio
        self.inspect_zip = inspect_zip
        self.seed = seed
        self.process_shard = process_shard

    def iter(self, epoch: int = 0) -> PipelineIterator:
        return _FileSourceIter(self)


class _FileSourceIter(PipelineIterator):
    def __init__(self, src: FileSource):
        fault_site("data.list")
        from mmlspark_tpu_torch.io.readers import list_binary_entries
        self._entries = list_binary_entries(
            src.path, src.recursive, src.sample_ratio, src.inspect_zip,
            src.seed, src.process_shard)
        self._cursor = 0
        self._zip_path: Optional[str] = None
        self._zip = None

    def __next__(self) -> Record:
        if self._cursor >= len(self._entries):
            raise StopIteration
        f, inner = self._entries[self._cursor]
        if inner is None:
            with open(f, "rb") as fh:
                path, data = f, fh.read()
        else:
            if self._zip_path != f:
                self.close()
                import zipfile
                self._zip_path, self._zip = f, zipfile.ZipFile(f)
            path, data = f"{f}/{inner}", self._zip.read(inner)
        self._cursor += 1
        return {"path": path, "bytes": fault_site("readers.read",
                                                  payload=data)}

    def state_dict(self) -> Dict[str, Any]:
        return {"cursor": self._cursor, "n": len(self._entries)}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if int(state["n"]) != len(self._entries):
            raise ValueError(
                f"FileSource listing changed: snapshot saw {state['n']} "
                f"entries, this run lists {len(self._entries)} — resume "
                "requires the same files on disk")
        self._cursor = int(state["cursor"])

    def close(self) -> None:
        if self._zip is not None:
            self._zip.close()
            self._zip_path, self._zip = None, None


# -- shuffle -----------------------------------------------------------------

class ShuffleBuffer(Dataset):
    """Seeded windowed shuffle: read ``window`` records, permute the block
    with ``random.Random((seed, epoch, block_index))``, yield it, repeat.

    Block (not reservoir) shuffling makes resume exact AND cheap: the
    snapshot is (upstream state at block start, block index, position), so
    a restore re-pulls one window from the restored upstream, re-applies
    the same permutation, and skips to the position — no buffered records
    ever serialize.
    """

    def __init__(self, upstream: Dataset, window: Optional[int] = None,
                 seed: int = 0):
        window = int(window if window is not None
                     else mmlconfig.get("data.shuffle_window"))
        if window < 1:
            raise ValueError(f"shuffle window must be >= 1, got {window}")
        self.upstream = upstream
        self.window = window
        self.seed = seed

    def iter(self, epoch: int = 0) -> PipelineIterator:
        return _ShuffleIter(self.upstream.iter(epoch), self.window,
                            self.seed, epoch)


class _ShuffleIter(PipelineIterator):
    def __init__(self, up: PipelineIterator, window: int, seed: int,
                 epoch: int):
        self._up = up
        self._window = window
        self._seed = seed
        self._epoch = epoch
        self._block: List[Any] = []
        self._pos = 0
        self._blocks_done = 0                 # buffer refill count
        self._up_at_block = up.state_dict()   # upstream state at block start

    def __next__(self) -> Any:
        while self._pos >= len(self._block):
            self._refill()  # raises StopIteration when upstream is dry
        item = self._block[self._pos]
        self._pos += 1
        return item

    def _refill(self) -> None:
        snap = self._up.state_dict()
        block: List[Any] = []
        while len(block) < self._window:
            try:
                block.append(next(self._up))
            except StopIteration:
                break
        if not block:
            raise StopIteration
        fault_site("data.shuffle")
        # str seeding hashes with sha512 -> stable across interpreters
        # (tuple seeding is hash-based: deprecated and PYTHONHASHSEED-
        # dependent, which would break cross-run resume determinism)
        rng = random.Random(f"{self._seed}:{self._epoch}:{self._blocks_done}")
        rng.shuffle(block)
        self._up_at_block = snap
        self._block = block
        self._pos = 0
        self._blocks_done += 1
        if obsmetrics.metrics_enabled():
            obsmetrics.gauge("data.shuffle_fill").set(len(block))

    def state_dict(self) -> Dict[str, Any]:
        return {"blocks": self._blocks_done, "pos": self._pos,
                "upstream": self._up_at_block}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        blocks, pos = int(state["blocks"]), int(state["pos"])
        self._up.load_state_dict(state["upstream"])
        self._block, self._pos = [], 0
        self._blocks_done = max(blocks - 1, 0)
        self._up_at_block = self._up.state_dict()
        if blocks > 0:
            self._refill()  # replays block `blocks-1` with its original perm
        self._pos = pos

    def close(self) -> None:
        self._up.close()


# -- parallel decode ---------------------------------------------------------

def default_decode(record: Record) -> Optional[Record]:
    """``{"path","bytes"}`` -> ``{"path","image"}`` via ``io.codecs``;
    ``None`` (drop) when undecodable — ``ImageReader.scala:55-59``
    semantics."""
    from mmlspark_tpu_torch.io.codecs import decode_image
    arr = decode_image(record["bytes"])
    if arr is None:
        return None
    return {"path": record["path"], "image": arr}


class ParallelDecode(Dataset):
    """Bounded worker pool applying ``fn`` (default: image decode) off the
    consumer thread, in submission order.

    Records submit in chunks of ``chunk`` (one future per chunk — a
    per-record future's executor round-trip costs more than a small image
    decode, so chunking is what lets fast decodes still win); up to
    ``2 * workers`` chunks stay in flight, and results pop strictly in
    submission order, so output is deterministic regardless of worker
    scheduling. ``fn`` returning ``None`` drops the record (counted in the
    ``data.decode_dropped`` metric). The snapshot commits only CONSUMED
    records — per record, not per chunk — so a crash mid-flight just
    re-decodes the in-flight tail on resume.
    """

    def __init__(self, upstream: Dataset,
                 fn: Optional[Callable[[Record], Optional[Record]]] = None,
                 workers: Optional[int] = None, chunk: int = 16):
        workers = int(workers if workers is not None
                      else mmlconfig.get("data.decode_workers"))
        if workers < 1:
            raise ValueError(f"decode workers must be >= 1, got {workers}")
        if chunk < 1:
            raise ValueError(f"decode chunk must be >= 1, got {chunk}")
        self.upstream = upstream
        self.fn = fn if fn is not None else default_decode
        self.workers = workers
        self.chunk = chunk

    def iter(self, epoch: int = 0) -> PipelineIterator:
        return _DecodeIter(self.upstream.iter(epoch), self.fn, self.workers,
                           self.chunk)


class _DecodeIter(PipelineIterator):
    def __init__(self, up: PipelineIterator,
                 fn: Callable[[Record], Optional[Record]], workers: int,
                 chunk: int):
        self._up = up
        self._fn = fn
        self._chunk = chunk
        self._depth = workers * 2          # in-flight CHUNKS
        self._pool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="mmlspark-tpu-decode")
        self._inflight: deque = deque()    # (future -> [out], [snap]) chunks
        self._ready: deque = deque()       # (out, snap) per record, in order
        self._exhausted = False
        self._consumed = up.state_dict()
        self._telemetry = obsmetrics.metrics_enabled()
        # liveness: workers beat per decoded record (atomic write, shared
        # handle) — a hung codec shows as this heartbeat going silent
        self._hb = _watchdog.register("data.decode")

    def _run(self, recs: List[Record]) -> List[Optional[Record]]:
        if not self._telemetry:
            out = []
            for r in recs:
                out.append(self._fn(r))
                self._hb.beat()
            return out
        out = []
        hist = obsmetrics.histogram("data.decode_seconds")
        for r in recs:
            t0 = obsevents.perf()
            out.append(self._fn(r))
            self._hb.beat()
            hist.observe(obsevents.perf() - t0)
        return out

    def _top_up(self) -> None:
        while not self._exhausted and len(self._inflight) < self._depth:
            recs: List[Record] = []
            snaps: List[Dict[str, Any]] = []
            while len(recs) < self._chunk:
                try:
                    rec = next(self._up)
                except StopIteration:
                    self._exhausted = True
                    break
                # the fault site fires on the CONSUMER thread as each record
                # joins a chunk, so Nth-hit plans stay deterministic (worker
                # scheduling is not)
                fault_site("data.decode")
                recs.append(rec)
                snaps.append(self._up.state_dict())
            if not recs:
                return
            self._inflight.append((self._pool.submit(self._run, recs), snaps))

    def __next__(self) -> Record:
        while True:
            while not self._ready:
                self._top_up()
                if not self._inflight:
                    raise StopIteration
                fut, snaps = self._inflight.popleft()
                if self._telemetry:
                    t0 = obsevents.perf()
                    outs = fut.result()
                    obsmetrics.histogram(
                        "data.decode_wait_seconds").observe(
                        obsevents.perf() - t0)
                    obsmetrics.gauge("data.decode_queue_depth").set(
                        len(self._inflight))
                else:
                    outs = fut.result()
                self._ready.extend(zip(outs, snaps))
            out, snap = self._ready.popleft()
            self._consumed = snap
            if out is None:
                obsmetrics.counter("data.decode_dropped").inc()
                continue
            return out

    def state_dict(self) -> Dict[str, Any]:
        return {"upstream": self._consumed}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._abandon_inflight()
        self._up.load_state_dict(state["upstream"])
        self._consumed = self._up.state_dict()
        self._exhausted = False

    def _abandon_inflight(self) -> None:
        for fut, _snaps in self._inflight:
            fut.cancel()
        self._inflight.clear()
        self._ready.clear()

    def close(self) -> None:
        self._hb.close()
        self._abandon_inflight()
        self._pool.shutdown(wait=True, cancel_futures=True)
        self._up.close()


# -- map ---------------------------------------------------------------------

class MapRecords(Dataset):
    """1:1 transform on the consumer thread (parsing, label derivation).
    ``fn`` must be deterministic — it is replayed on resume."""

    def __init__(self, upstream: Dataset, fn: Callable[[Any], Any]):
        self.upstream = upstream
        self.fn = fn

    def iter(self, epoch: int = 0) -> PipelineIterator:
        return _MapIter(self.upstream.iter(epoch), self.fn)


class _MapIter(PipelineIterator):
    def __init__(self, up: PipelineIterator, fn: Callable[[Any], Any]):
        self._up = up
        self._fn = fn

    def __next__(self) -> Any:
        return self._fn(next(self._up))

    def state_dict(self) -> Dict[str, Any]:
        return {"upstream": self._up.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._up.load_state_dict(state["upstream"])

    def close(self) -> None:
        self._up.close()


# -- batch -------------------------------------------------------------------

class Batcher(Dataset):
    """Stack ``size`` records into one host-batch dict of numpy columns.

    Remainder policies match the trainer's global-batch contract (every
    step sees the same batch shape):

    - ``"drop"`` — discard a short final batch;
    - ``"pad"``  — zero-fill to ``size`` and mask via a float32 ``weight``
      column (1.0 real / 0.0 pad) — the ``learners._pad_xyw`` convention;
    - ``"keep"`` — yield the short batch as-is (host-side consumers only).

    Numeric record fields stack (shapes must agree — resize images first
    via ``map``); strings/bytes/objects become object columns.

    ``multi_hot`` maps RAGGED id-list columns to a fixed slot width (the
    recommender's sparse-feature wire contract): each record's
    variable-length id sequence pads to ``slots`` with
    ``MULTI_HOT_PAD_ID`` (truncating overflow deterministically from the
    front-kept side) and gains a float32 ``<col>_weight`` mask column
    (1.0 real slot / 0.0 pad), so downstream embedding bag lookups see
    static shapes and zero-weighted pads — the same pad-and-mask
    convention ``embed.tables`` reserves row 0 for. The transform is
    stateless, so snapshot/resume bit-identity is untouched.
    """

    REMAINDERS = ("drop", "pad", "keep")

    def __init__(self, upstream: Dataset, size: int, remainder: str = "drop",
                 multi_hot: Optional[Dict[str, int]] = None):
        if size < 1:
            raise ValueError(f"batch size must be >= 1, got {size}")
        if remainder not in self.REMAINDERS:
            raise ValueError(f"remainder must be one of {self.REMAINDERS}, "
                             f"got {remainder!r}")
        if multi_hot:
            for col, slots in multi_hot.items():
                if int(slots) < 1:
                    raise ValueError(
                        f"multi_hot slots must be >= 1, got {col}={slots}")
        self.upstream = upstream
        self.size = size
        self.remainder = remainder
        self.multi_hot = dict(multi_hot or {})

    def iter(self, epoch: int = 0) -> PipelineIterator:
        return _BatchIter(self.upstream.iter(epoch), self.size,
                          self.remainder, self.multi_hot)


# pad slot id for multi-hot columns; matches embed.tables.PAD_ID (row 0
# of every embedding table is the reserved all-zero pad row)
MULTI_HOT_PAD_ID = 0


def _pad_multi_hot(rows: List[Record],
                   multi_hot: Dict[str, int]) -> List[Record]:
    """Normalize ragged id-list columns to fixed ``(slots,)`` int32 rows
    plus per-slot weight masks. Pure per-record transform — no state, so
    the batch boundary snapshot stays the only resume cursor."""
    out: List[Record] = []
    for r in rows:
        r = dict(r)
        for col, slots in multi_hot.items():
            ids = np.asarray(r.get(col, ()), np.int64).reshape(-1)[:slots]
            padded = np.full(slots, MULTI_HOT_PAD_ID, np.int32)
            padded[:ids.size] = ids
            mask = np.zeros(slots, np.float32)
            mask[:ids.size] = 1.0
            r[col] = padded
            r[f"{col}_weight"] = mask
        out.append(r)
    return out


def _stack_records(rows: List[Record], pad_to: Optional[int] = None
                   ) -> Dict[str, np.ndarray]:
    n = len(rows)
    out: Dict[str, np.ndarray] = {}
    for key in rows[0]:
        vals = [r[key] for r in rows]
        first = vals[0]
        if isinstance(first, np.ndarray) and first.dtype != np.object_:
            col = np.stack(vals)
        elif isinstance(first, (bool, int, float, np.bool_, np.integer,
                                np.floating)):
            col = np.asarray(vals)
        else:
            col = np.empty(n, dtype=np.object_)
            for i, v in enumerate(vals):
                col[i] = v
        out[key] = col
    if pad_to is not None and pad_to > n:
        for key, col in out.items():
            if col.dtype == np.object_:
                padded = np.empty(pad_to, dtype=np.object_)
                padded[:n] = col
                out[key] = padded
            else:
                pad = np.zeros((pad_to - n,) + col.shape[1:], col.dtype)
                out[key] = np.concatenate([col, pad])
        weight = out.get("weight")
        if weight is None:
            weight = np.ones(pad_to, np.float32)
        weight = np.asarray(weight, np.float32).copy()
        weight[n:] = 0.0
        out["weight"] = weight
    return out


class _BatchIter(PipelineIterator):
    def __init__(self, up: PipelineIterator, size: int, remainder: str,
                 multi_hot: Optional[Dict[str, int]] = None):
        self._up = up
        self._size = size
        self._remainder = remainder
        self._multi_hot = dict(multi_hot or {})
        self._boundary = up.state_dict()  # upstream state at last batch edge

    def __next__(self) -> Dict[str, np.ndarray]:
        rows: List[Record] = []
        while len(rows) < self._size:
            try:
                rows.append(next(self._up))
            except StopIteration:
                break
        if not rows:
            raise StopIteration
        if self._multi_hot:
            rows = _pad_multi_hot(rows, self._multi_hot)
        if len(rows) < self._size:
            if self._remainder == "drop":
                raise StopIteration
            pad_to = self._size if self._remainder == "pad" else None
            batch = _stack_records(rows, pad_to=pad_to)
        else:
            batch = _stack_records(rows)
        self._boundary = self._up.state_dict()
        return batch

    def state_dict(self) -> Dict[str, Any]:
        return {"upstream": self._boundary}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._up.load_state_dict(state["upstream"])
        self._boundary = self._up.state_dict()

    def close(self) -> None:
        self._up.close()


# -- repeat ------------------------------------------------------------------

class Repeat(Dataset):
    """Re-run the inner pipeline for ``epochs`` passes (``None`` = forever),
    folding the epoch number into every shuffle seed downstream of the
    source. Emits a ``data.epoch`` telemetry event at each epoch boundary
    (epoch, items, wall_s) — the run report's "input pipeline" section."""

    def __init__(self, upstream: Dataset, epochs: Optional[int] = None):
        if epochs is not None and epochs < 1:
            raise ValueError(f"epochs must be >= 1 or None, got {epochs}")
        self.upstream = upstream
        self.epochs = epochs

    def iter(self, epoch: int = 0) -> PipelineIterator:
        return _RepeatIter(self.upstream, self.epochs, start_epoch=epoch)


class _RepeatIter(PipelineIterator):
    def __init__(self, ds: Dataset, epochs: Optional[int], start_epoch: int):
        self._ds = ds
        self._epochs = epochs
        self._epoch = start_epoch
        self._inner: Optional[PipelineIterator] = ds.iter(start_epoch)
        self._items = 0
        self._t0 = obsevents.perf()

    def __next__(self) -> Any:
        while True:
            if self._inner is None:
                raise StopIteration
            try:
                item = next(self._inner)
            except StopIteration:
                self._roll_epoch()
                continue
            self._items += 1
            return item

    def _roll_epoch(self) -> None:
        if obsevents.events_enabled():
            obsevents.emit("event", "data.epoch", epoch=self._epoch,
                           items=self._items,
                           wall_s=round(obsevents.perf() - self._t0, 6))
        empty = self._items == 0
        self._inner.close()
        self._epoch += 1
        self._items = 0
        self._t0 = obsevents.perf()
        if empty or (self._epochs is not None
                     and self._epoch >= self._epochs):
            # an empty pass on an infinite repeat would spin forever
            self._inner = None
            raise StopIteration
        self._inner = self._ds.iter(self._epoch)

    def state_dict(self) -> Dict[str, Any]:
        return {"epoch": self._epoch, "items": self._items,
                "inner": None if self._inner is None
                else self._inner.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if self._inner is not None:
            self._inner.close()
        self._epoch = int(state["epoch"])
        self._items = int(state["items"])
        self._t0 = obsevents.perf()
        if state["inner"] is None:
            self._inner = None
        else:
            self._inner = self._ds.iter(self._epoch)
            self._inner.load_state_dict(state["inner"])

    def close(self) -> None:
        if self._inner is not None:
            self._inner.close()
