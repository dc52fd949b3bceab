"""Device-resident scoring inputs: transfer once, score from device slices.

The port of ``mmlspark_tpu/models/residency.py``. Scoring workloads re-read
one immutable frame many times (FindBestModel candidates, repeated
evaluation passes), so the coerced input crosses host->device once and is
kept as a ``(steps, bs, ...)`` device tensor:

- keyed weakly on the Frame object (frames are immutable-by-convention;
  the upload dies with the frame, never goes stale);
- sub-keyed on the coercion fingerprint (column, batch shape, dtype,
  preprocessing), so models that feed identically share one upload;
- budget-checked against ``runtime.device_cache_mb`` (:func:`_fits`) — an
  over-budget frame falls back to the streaming loop, it never runs the
  card out of memory;
- single-frame: uploading a NEW frame evicts the previous frame's entries,
  bounding residency to one frame's worth.

A miss times ``build()`` in a hot ``score:stack`` span and the upload in
``score:upload`` (``observability/spans.py``).
"""
from __future__ import annotations

import weakref
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.observability.spans import span
from mmlspark_tpu_torch.utils import config as mmlconfig

# frame -> {fingerprint: stacked device tensor (steps, bs, ...)}; consumers
# recompute per-batch valid rows from frame.count()
_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_TOTAL_UPLOADS = 0   # cumulative device copies since clear() (observability)


def resident_batches(frame, fingerprint: Tuple, build: Callable[[], np.ndarray],
                     device: torch.device, force: bool = False,
                     budget_mb: Optional[float] = None,
                     nbytes_hint: Optional[int] = None):
    """The device-resident (steps, bs, ...) stack for ``frame``, or None.

    ``build()`` returns the fully coerced, tail-padded host stack; it runs
    only on a cache miss. ``nbytes_hint`` (the stack size computed from
    shapes/dtypes) lets an over-budget frame be rejected BEFORE build()
    materializes a full-dataset host copy. The post-build check on actual
    nbytes still runs. ``force=True`` skips both (deviceCache='on').
    ``device`` is part of the key: a stack lives on one device.
    """
    if getattr(frame, "_out_of_core", False):
        # out-of-core frames must never materialize through build() —
        # streaming them is their whole point
        return None
    key = (str(device),) + tuple(fingerprint)
    entries = _CACHE.get(frame)
    if entries is not None and key in entries:
        return entries[key]
    if not force and nbytes_hint is not None \
            and not _fits(nbytes_hint, budget_mb):
        return None
    with span("score", "stack", hot=True):
        host = build()
    if not force and not _fits(host.nbytes, budget_mb):
        return None
    global _TOTAL_UPLOADS
    _TOTAL_UPLOADS += 1
    with span("score", "upload", hot=True, bytes=host.nbytes):
        dev = torch.from_numpy(host).to(device)
    if entries is None:
        _CACHE.clear()          # single-frame policy: evict other frames
        entries = _CACHE.setdefault(frame, {})
    entries[key] = dev
    return dev


def _fits(nbytes: int, budget_mb: Optional[float] = None) -> bool:
    """2x charge like the reference's DeviceEpochCache.fits: the resident
    stack plus the transiently-live batch slices at the consumer's peak."""
    if budget_mb is None:
        budget_mb = float(mmlconfig.get("runtime.device_cache_mb"))
    return nbytes * 2 <= budget_mb * 1e6


def clear() -> None:
    """Drop every resident upload (tests; explicit device-memory release)."""
    global _TOTAL_UPLOADS
    _TOTAL_UPLOADS = 0
    _CACHE.clear()


def stats() -> Dict[str, int]:
    """Introspection for tests: live cached frames/uploads, plus the
    cumulative upload count since ``clear()``."""
    return {"frames": len(_CACHE),
            "uploads": sum(len(v) for v in _CACHE.values()),
            "total_uploads": _TOTAL_UPLOADS}
