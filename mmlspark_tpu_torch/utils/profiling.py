"""Profiling hooks: ``torch.profiler`` traces and named regions.

The port of ``mmlspark_tpu/utils/profiling.py``. :func:`trace` captures
the host's and, with CUDA present, the card's activity over a region and
writes it as a Chrome trace (``trace-<pid>-<n>.json``, which Perfetto
and chrome://tracing open) under ``trace_dir`` or the
``profiling.trace_dir`` key, so a run becomes a profiled run by setting
``MMLSPARK_TPU_TORCH_PROFILING_TRACE_DIR`` alone. :func:`annotate` is
``torch.profiler.record_function``: the region shows by name in such a
trace (``span()`` opens one under ``observability.annotate``).

Only the instrumentation is failure-safe: a profiler that cannot start
or write its trace logs a warning and the region runs unprofiled; an
error raised inside the region propagates as it would without the
trace. A :func:`trace` inside another is a no-op with a warning (one
profiler runs at a time), and the outer capture goes on.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
from typing import Iterator, Optional

from mmlspark_tpu_torch.utils import config
from mmlspark_tpu_torch.utils.logging import get_logger

_lock = threading.Lock()
_tracing = False
_seq = itertools.count(1)


@contextlib.contextmanager
def trace(trace_dir: Optional[str] = None) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the enclosed region into
    ``trace_dir`` (default ``profiling.trace_dir``; a no-op when neither
    is set, so it is safe to leave on production paths)."""
    global _tracing
    target = trace_dir if trace_dir is not None else config.get(
        "profiling.trace_dir")
    if not target:
        yield
        return
    log = get_logger("profiling")
    with _lock:
        nested = _tracing
        _tracing = True
    if nested:
        log.warning("nested trace(%s) ignored: a capture is already running",
                    target)
        yield
        return
    prof = None
    try:
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.__enter__()
            log.info("capturing a torch.profiler trace into %s", target)
        except Exception as e:
            prof = None
            log.warning("torch.profiler unavailable (%s: %s); trace() is a "
                        "no-op", type(e).__name__, e)
        try:
            yield
        finally:
            if prof is not None:
                try:
                    prof.__exit__(None, None, None)
                    os.makedirs(target, exist_ok=True)
                    path = os.path.join(
                        target, f"trace-{os.getpid()}-{next(_seq)}.json")
                    prof.export_chrome_trace(path)
                    log.info("wrote a torch.profiler trace to %s", path)
                except Exception as e:
                    log.warning("torch.profiler trace not written (%s: %s)",
                                type(e).__name__, e)
    finally:
        with _lock:
            _tracing = False


def annotate(name: str):
    """Named region of a ``torch.profiler`` trace
    (``torch.profiler.record_function``)."""
    import torch
    return torch.profiler.record_function(name)
