"""File readers: the CSV reader of the tabular paths.

The PyTorch port's part of ``mmlspark_tpu/io/readers.py``: ``read_csv``
with its column type inference, the one reader the AutoML path and its
golden tests call. The binary-file and image readers (and their codecs)
are not ported yet (ROADMAP, queue A "I/O and the rest").

``process_shard=True`` keeps this process's contiguous slice, taking the
rank and world size from an initialized ``torch.distributed`` process
group (0 of 1 without one), as ``Frame.process_shard`` does.
"""
from __future__ import annotations

import csv as _csv
from typing import List

import numpy as np

from mmlspark_tpu_torch.core.frame import Frame


def _process_slice(items: List, process_shard: bool) -> List:
    """This process's contiguous slice of a sorted work list (multi-process
    ingestion: every process lists the same items and keeps only its
    share)."""
    if not process_shard:
        return items
    import torch.distributed as dist
    live = dist.is_available() and dist.is_initialized()
    i = dist.get_rank() if live else 0
    p = dist.get_world_size() if live else 1
    bounds = np.linspace(0, len(items), p + 1).astype(int)
    return items[bounds[i]:bounds[i + 1]]


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
