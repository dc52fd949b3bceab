"""Host-sync accounting: every device round trip is a counted event.

The port's counterpart of ``mmlspark_tpu/observability/syncs.py``. A
device->host fetch or a ``torch.cuda.synchronize`` drains the stream and
blocks the host; this module is the one place the port does either, and
each one is counted:

- a process total (:func:`total`), which a caller diffs around a phase;
- a per-site count (:func:`counts`), keyed by the site name and the
  innermost open span (:mod:`spans`), so a report can attribute the sync
  to the phase that paid for it.

Counting is a plain int add under a lock: cheap enough to be
unconditional.
"""
from __future__ import annotations

import threading
from typing import Dict

import numpy as np

from mmlspark_tpu_torch.observability import spans

_lock = threading.Lock()
_total = 0
_by_site: Dict[str, int] = {}


def total() -> int:
    """Lifetime sync-point count for this process."""
    return _total


def counts() -> Dict[str, int]:
    """Sync points per ``site`` (``site@span`` inside an open span)."""
    with _lock:
        return dict(_by_site)


def sync_point(site: str) -> None:
    """Record one host sync at ``site`` (e.g. ``"transform.retire"``)."""
    global _total
    cur = spans.current_span()
    key = f"{site}@{cur}" if cur else site
    with _lock:
        _total += 1
        _by_site[key] = _by_site.get(key, 0) + 1


def device_get(x, site: str) -> np.ndarray:
    """Counted device->host fetch of one tensor, as a numpy array.
    bfloat16 (which numpy lacks) is widened to float32 on the host, so the
    wire still carries half the bytes."""
    import torch
    sync_point(site)
    host = x.detach().to("cpu")
    if host.dtype == torch.bfloat16:
        host = host.float()
    return host.numpy()


def synchronize(site: str, device=None) -> None:
    """Counted ``torch.cuda.synchronize`` (a no-op wait on the CPU)."""
    import torch
    sync_point(site)
    if device is None or torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reset() -> None:
    """Zero the counts (tests measuring per-phase deltas)."""
    global _total
    with _lock:
        _total = 0
        _by_site.clear()
