"""Process-wide JSON-lines event log with an injectable clock.

The port of ``mmlspark_tpu/observability/events.py``: one append-only
stream of ``{"ts", "type", "name", ...}`` lines, off until
``observability.events_path`` is set. :func:`emit` appends and flushes
under a lock, so threads interleave whole lines, and hands every event to
the flight recorder's ring (:mod:`flightrec`, on by default), so a dump
has the timeline even in a run that never set an events path.
:func:`perf` is the monotonic clock every duration is read from,
:func:`wall` the clock of event timestamps; both are injectable
(:func:`set_clock`) so tests write byte-deterministic logs.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Optional

from mmlspark_tpu_torch.observability import flightrec
from mmlspark_tpu_torch.utils import config

_lock = threading.Lock()
# injectable clock: [wall, perf], swapped under _lock
_clock = [time.time, time.perf_counter]
_writer_path: Optional[str] = None
_writer_fh = None


def wall() -> float:
    """Wall-clock seconds (event timestamps)."""
    return _clock[0]()


def perf() -> float:
    """Monotonic seconds (durations)."""
    return _clock[1]()


def set_clock(wall_fn: Optional[Callable[[], float]] = None,
              perf_fn: Optional[Callable[[], float]] = None) -> None:
    """Inject fake clocks (tests). ``None`` leaves that clock unchanged."""
    with _lock:
        if wall_fn is not None:
            _clock[0] = wall_fn
        if perf_fn is not None:
            _clock[1] = perf_fn


def reset_clock() -> None:
    with _lock:
        _clock[0] = time.time
        _clock[1] = time.perf_counter


def events_enabled() -> bool:
    """Is the event log on? Per-step hot paths check this before building
    events."""
    return bool(config.get("observability.events_path"))


def recording_enabled() -> bool:
    """Is any event sink live: the JSON-lines log or the flight
    recorder's ring? Cold and incident paths gate on this, so a
    post-mortem timeline exists in runs that never set an events path."""
    return bool(config.get("observability.events_path")) \
        or flightrec.active()


def emit(etype: str, name: str, **fields: Any) -> None:
    """Append one event line and record it in the ring; a no-op while
    both sinks are off. ``fields`` that are not JSON-representable are
    written as ``str()``."""
    path = config.get("observability.events_path")
    ring = flightrec.active()
    if not (path or ring):
        return
    event = {"ts": round(wall(), 6), "type": etype, "name": name}
    event.update(fields)
    if ring:
        # the ring keeps the dict (serialized at dump time); nothing
        # mutates `event` after this point
        flightrec.record(event)
    if not path:
        return
    line = json.dumps(event, sort_keys=True, default=str)
    global _writer_path, _writer_fh
    with _lock:
        if _writer_path != path:
            if _writer_fh is not None:
                _writer_fh.close()
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            _writer_fh = open(path, "a", encoding="utf-8")
            _writer_path = path
        _writer_fh.write(line + "\n")
        _writer_fh.flush()


def close() -> None:
    """Close the writer (tests, clean shutdown); the next :func:`emit`
    reopens the file in append mode."""
    global _writer_path, _writer_fh
    with _lock:
        if _writer_fh is not None:
            _writer_fh.close()
        _writer_fh = None
        _writer_path = None
