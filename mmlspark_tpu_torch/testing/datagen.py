"""Random Frame generation for fuzzing and property tests.

The port's copy of ``mmlspark_tpu/testing/datagen.py``: the same seed gives
the same columns. A re-expression of the reference's random-dataset generator
(``core/test/datagen/src/main/scala/GenerateDataset.scala:27-64``): a seeded
generator produces frames with randomly chosen column kinds under caller
constraints, so save/load fuzzing and pipeline fuzzing never depend on real
data (SURVEY.md §4 "key fixture idea").
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from mmlspark_tpu_torch.core.frame import Frame

COLUMN_KINDS = ("int", "float", "double", "bool", "string", "tokens", "vector")

_WORDS = ("alpha bravo charlie delta echo foxtrot golf hotel india juliet "
          "kilo lima mike november oscar papa quebec romeo sierra tango").split()


def random_column(kind: str, n_rows: int, rng: np.random.Generator,
                  missing_ratio: float = 0.0, vector_dim: int = 4):
    """One random column of the given kind; object kinds honor missing_ratio."""
    miss = rng.uniform(0, 1, n_rows) < missing_ratio
    if kind == "int":
        return rng.integers(-100, 100, n_rows).astype(np.int32)
    if kind == "float":
        vals = rng.normal(0, 10, n_rows).astype(np.float32)
        vals[miss] = np.nan
        return vals
    if kind == "double":
        vals = rng.normal(0, 10, n_rows).astype(np.float64)
        vals[miss] = np.nan
        return vals
    if kind == "bool":
        return rng.uniform(0, 1, n_rows) > 0.5
    if kind == "string":
        return [None if m else rng.choice(_WORDS) for m in miss]
    if kind == "tokens":
        return [None if m else
                [str(w) for w in rng.choice(_WORDS, size=rng.integers(0, 6))]
                for m in miss]
    if kind == "vector":
        return rng.normal(0, 1, (n_rows, vector_dim)).astype(np.float32)
    raise ValueError(f"unknown column kind {kind!r}")


def generate_frame(n_rows: int = 32, n_cols: int = 4, seed: int = 0,
                   kinds: Optional[Sequence[str]] = None,
                   missing_ratio: float = 0.0,
                   num_partitions: int = 2,
                   with_label: Optional[str] = None,
                   n_classes: int = 2) -> Frame:
    """Random frame with ``n_cols`` columns of random (or given) kinds.

    ``with_label``: add a ``"label"`` column — "class" (int in [0,n_classes))
    or "real" (float). Column names are ``col0..colN``.
    """
    rng = np.random.default_rng(seed)
    data: Dict[str, object] = {}
    for i in range(n_cols):
        kind = kinds[i % len(kinds)] if kinds else rng.choice(COLUMN_KINDS)
        data[f"col{i}"] = random_column(str(kind), n_rows, rng, missing_ratio)
    if with_label == "class":
        data["label"] = rng.integers(0, n_classes, n_rows).astype(np.int32)
    elif with_label == "real":
        data["label"] = rng.normal(0, 1, n_rows).astype(np.float64)
    return Frame.from_dict(data, num_partitions=num_partitions)
