"""Process-wide JSON-lines event log.

The port's minimal copy of ``mmlspark_tpu/observability/events.py``: one
append-only stream of ``{"ts", "type", "name", ...}`` lines, off until
``observability.events_path`` is set. :func:`emit` appends and flushes
under a lock, so threads interleave whole lines. :func:`perf` is the
monotonic clock every duration is read from, :func:`wall` the clock of
event timestamps. The flight recorder and the injectable clock of the
reference are not ported yet (ROADMAP, observability), so
:func:`recording_enabled` is :func:`events_enabled`.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Optional

from mmlspark_tpu_torch.utils import config

_lock = threading.Lock()
_writer_path: Optional[str] = None
_writer_fh = None


def perf() -> float:
    """Monotonic seconds (durations)."""
    return time.perf_counter()


def wall() -> float:
    """Wall-clock seconds (event timestamps)."""
    return time.time()


def events_enabled() -> bool:
    """Is the event log on? Hot paths check this before building events."""
    return bool(config.get("observability.events_path"))


def recording_enabled() -> bool:
    """Is any event sink live? Cold and incident paths gate on this; with
    no flight recorder ported, the JSON-lines log is the only sink."""
    return events_enabled()


def emit(etype: str, name: str, **fields: Any) -> None:
    """Append one event line; a no-op while the log is off. ``fields``
    that are not JSON-representable are written as ``str()``."""
    path = config.get("observability.events_path")
    if not path:
        return
    event = {"ts": round(wall(), 6), "type": etype, "name": name}
    event.update(fields)
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
