"""Host-sync accounting: every device round trip is a counted event.

The port's counterpart of ``mmlspark_tpu/observability/syncs.py``. A
device->host fetch or a wait on a CUDA stream drains the launch queue and
blocks the host; this module is the one place the port does either, and
each one is counted:

- a process total (:func:`total`), which a caller diffs around a phase
  (the trainer's ``train.sync_points_per_step`` gauge);
- a per-site count (:func:`counts`), keyed by the site name and the
  innermost open span (:mod:`spans`), so a report can attribute the sync
  to the phase that paid for it;
- the registry counters ``observability.sync_points`` and
  ``observability.sync_points.<site>`` (:mod:`metrics`);
- a ``sync.point`` event (site, kind, the innermost span's name and id)
  when an event sink is live: the log, or the flight recorder's ring,
  which is on by default.

Counting is a plain int add under a lock: cheap enough to be
unconditional.
"""
from __future__ import annotations

import threading
from collections.abc import Mapping
from typing import Any, Dict

from mmlspark_tpu_torch.observability import events, metrics, spans

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


def sync_point(site: str, kind: str = "sync") -> None:
    """Record one host sync at ``site`` (e.g. ``"transform.retire"``);
    ``kind`` names the blocking primitive for the event log."""
    global _total
    cur = spans.current_span()
    key = f"{site}@{cur[0]}" if cur else site
    with _lock:
        _total += 1
        _by_site[key] = _by_site.get(key, 0) + 1
    metrics.counter("observability.sync_points").inc()
    metrics.counter(f"observability.sync_points.{site}").inc()
    if events.recording_enabled():
        events.emit("event", "sync.point", site=site, kind=kind,
                    span=cur[0] if cur else None,
                    span_id=cur[1] if cur else None)


def _to_host(x) -> Any:
    import torch
    if isinstance(x, Mapping):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    # copy=True: a CPU tensor must not come back aliasing live device-side
    # state (the trainer's ring is written in place)
    host = x.detach().to("cpu", copy=True)
    if host.dtype == torch.bfloat16:
        host = host.float()
    return host.numpy()


def device_get(x, site: str) -> Any:
    """Counted device->host fetch of a tensor, or of a dict / list / tuple
    of tensors (one sync point for all of them), as numpy arrays.
    bfloat16 (which numpy lacks) is widened to float32 on the host, so the
    wire still carries half the bytes."""
    sync_point(site, "device_get")
    return _to_host(x)


def block_until_ready(x, site: str):
    """Counted wait until the work that produces ``x`` (a tensor, or a
    dict / list / tuple of them) has finished: the current stream of each
    CUDA device holding one is synchronized. Tensors on the CPU are ready
    already. Returns ``x``."""
    import torch
    sync_point(site, "block_until_ready")
    leaves = (x.values() if isinstance(x, Mapping)
              else x if isinstance(x, (list, tuple)) else [x])
    for d in {t.device for t in leaves if isinstance(t, torch.Tensor)
              and t.device.type == "cuda"}:
        torch.cuda.current_stream(d).synchronize()
    return x


def synchronize(site: str, device=None) -> None:
    """Counted wait for all work on ``device`` (``runtime.device`` when
    None): ``torch.cuda.synchronize`` on a CUDA device, nothing on the
    CPU, where every op has finished when it returns."""
    import torch
    sync_point(site, "synchronize")
    if device is None:
        from mmlspark_tpu_torch.utils import config
        device = config.get("runtime.device")
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset() -> None:
    """Zero the counts (tests measuring per-phase deltas)."""
    global _total
    with _lock:
        _total = 0
        _by_site.clear()
