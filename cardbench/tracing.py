"""Spans around the benchmark's own calls, and the reduction of a
``torch.profiler`` trace of the device to what the per-layer readers read.

The profiler traces the device alone (CUDA activity): tracing every host
operator as well slowed a ViT training step by a third. The benchmark's
spans are kept here, on ``time.time_ns()``, the clock the profiler puts
device timestamps on, so an idle gap on the device can be labelled with
the span the host was in. With tracing off a span costs nothing."""
import contextlib
import threading
import time
from typing import Dict, List, Optional

import torch


class Tracer:
    """``span(name)`` contexts, and one profiled stretch of the window
    (``start`` .. ``stop``) when ``on``."""

    def __init__(self, on: bool):
        self.on = on
        self._prof = None
        self._spans: List[tuple] = []
        self._t0 = None

    @contextlib.contextmanager
    def span(self, name: str):
        if self._prof is None:
            yield
            return
        t = time.time_ns()
        try:
            yield
        finally:
            self._spans.append((name, t, time.time_ns(), threading.get_ident()))

    def _profile(self):
        acts = [torch.profiler.ProfilerActivity.CUDA] \
            if torch.cuda.is_available() else [torch.profiler.ProfilerActivity.CPU]
        return torch.profiler.profile(activities=acts)

    def warm(self) -> None:
        """Start and stop the profiler once, during set-up, so that its
        first start does not stall the window."""
        if not self.on:
            return
        with self._profile():
            torch.zeros(1).add_(1)

    def start(self) -> None:
        if not self.on:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._spans = []
        prof = self._profile()
        prof.start()
        self._t0 = time.time_ns()
        self._prof = prof

    def stop(self) -> Optional[Dict]:
        """End the stretch: the reduced trace, or None when off."""
        if self._prof is None:
            return None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t1 = time.time_ns()
        prof, self._prof = self._prof, None
        prof.stop()
        events = prof.profiler.kineto_results.events()
        local = torch.cuda.current_device() if torch.cuda.is_available() else 0
        return reduce(list(events), self._spans, (self._t0, t1), local)


def _is_device_op(e) -> bool:
    if "CUDA" not in str(e.device_type()) or e.name().startswith("cb:"):
        return False
    try:
        if e.is_user_annotation():
            return False
    except AttributeError:
        pass
    try:
        return str(e.activity_type()) in ("kernel", "gpu_memcpy", "gpu_memset")
    except AttributeError:
        return True


def _union(intervals: List[tuple]) -> List[tuple]:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def reduce(events, spans, window, device: int = 0) -> Dict:
    """The traced stretch of this process's ``device`` as plain numbers
    (seconds from its start): ``window_s``; ``busy_s`` (a list, one entry
    a device: the union of its operations; a cell on several cards
    gathers its ranks' there); ``ops`` [(name, device, start_s, dur_s)]
    inside the window; ``spans`` [(name, start_s, end_s, thread)];
    ``ops_in_window`` (the share of the traced device time that fell
    inside the window, a check of the two clocks)."""
    w0, w1 = window
    ops = [(e.name(), int(e.device_index()), e.start_ns(), e.end_ns())
           for e in events if _is_device_op(e)]
    ops = [o for o in ops if o[1] == device]
    total = sum(t - s for _, _, s, t in ops)
    clipped = [(n, d, max(s, w0), min(t, w1)) for n, d, s, t in ops
               if t > w0 and s < w1]
    busy = _union([(s, t) for _, _, s, t in clipped])
    inside = sum(t - s for _, _, s, t in clipped)
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": [sum(t - s for s, t in busy) / 1e9],
        "busy_intervals": busy,
        "ops": [(n, d, (s - w0) / 1e9, (t - s) / 1e9) for n, d, s, t in clipped],
        "spans": [(n, (s - w0) / 1e9, (t - w0) / 1e9, th)
                  for n, s, t, th in spans],
        "window_ns": window,
        "ops_in_window": inside / total if total else None,
    }


def device_ops_top(rec: Dict, k: int = 10) -> List[list]:
    """The ``k`` device operations that took most time on the traced
    device (rank 0's), summed by name over the window."""
    tot: Dict[str, float] = {}
    for n, _, _, dur in rec["ops"]:
        tot[n] = tot.get(n, 0.0) + dur
    return [list(kv) for kv in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


def idle_gaps_top(rec: Dict, k: int = 10) -> List[list]:
    """The ``k`` longest idle gaps of the traced device inside the window,
    each named by the innermost benchmark span open on the host when it
    began (``idle`` when none was)."""
    w0, w1 = rec["window_ns"]
    gaps, prev = [], w0
    for s, e in rec["busy_intervals"]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:k]:
        t = (s - w0) / 1e9
        open_ = [sp for sp in rec["spans"] if sp[1] <= t < sp[2]]
        label = min(open_, key=lambda sp: sp[2] - sp[1])[0] if open_ else "idle"
        out.append([label, (e - s) / 1e9])
    return out
