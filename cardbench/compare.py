"""The numbers that decide ``correct``, each held to a limit of its own
(``limits/<cell>.json``)."""
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def row_rel_err(answers: List[Tuple[np.ndarray, np.ndarray]],
                ref: Dict[int, np.ndarray]) -> Tuple[float, int]:
    """Worst ``|answer - reference| / |reference|`` (L2 over a row) over
    every answer, and how many answers were not finite. ``answers`` pairs
    the pool indices of a block of answers with their rows."""
    worst, bad = 0.0, 0
    for idx, rows in answers:
        want = np.stack([ref[int(i)] for i in idx])
        finite = np.isfinite(rows).all(axis=1)
        bad += int((~finite).sum())
        num = np.linalg.norm(rows.astype(np.float64) - want, axis=1)
        den = np.linalg.norm(want.astype(np.float64), axis=1)
        err = np.where(finite, num / np.maximum(den, 1e-30), np.inf)
        if err.size:
            worst = max(worst, float(err.max()))
    return worst, bad


def norm_gap(got: Sequence[float], want: Sequence[float],
             keep: Sequence[bool] = None) -> float:
    """Worst leaf of ``|norm_got - norm_want| / max(norm_want, median
    norm_want)`` over the leaves ``keep`` marks (all by default)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    keep = np.ones(want.shape, bool) if keep is None else np.asarray(keep)
    if not keep.any():
        return float("inf")
    floor = float(np.median(want[keep]))
    gap = np.abs(got - want) / np.maximum(want, floor)
    gap = np.where(np.isfinite(got), gap, np.inf)
    return float(gap[keep].max())


def loss_gap(got: Sequence[float], want: Sequence[float]) -> float:
    """Worst step of ``|loss_got - loss_want| / |loss_want|``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    gap = np.abs(got - want) / np.abs(want)
    return float(np.where(np.isfinite(got), gap, np.inf).max())


def leaf_norms(tensors: Sequence[torch.Tensor]) -> List[float]:
    """Float64 L2 norm of each tensor, fetched in one copy."""
    if not tensors:
        return []
    stacked = torch.stack([t.detach().double().norm() for t in tensors])
    return stacked.cpu().tolist()
