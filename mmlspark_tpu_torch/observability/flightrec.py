"""Flight recorder: a bounded in-memory ring of the last N events.

The port of ``mmlspark_tpu/observability/flightrec.py``: the post-mortem
half of the event log. The JSONL log
(``observability.events_path``) is opt-in and append-everything; the
flight recorder is ON by default (``observability.flight_recorder_size``,
0 disables) and keeps only the most recent events in memory — no I/O, no
growth — so when something goes wrong in a run that never configured an
events path, there is still a timeline to dump:

- the watchdog dumps it when a heartbeat stalls (``watchdog.stall``);
- the CLI dumps it on an unhandled crash.

:func:`record` is called by :func:`events.emit` for every event it sees
(the ring stores the event dict as-is; JSON serialization happens only at
:func:`dump` time), so anything the event log would have captured is in
the ring — including the incident event itself, which is why a dump is
never empty when recording is on.

Dumps are JSONL (same schema as the event log — ``mmlspark-tpu-torch report``
and ``--trace`` read them directly) prefixed with one ``flightrec.dump``
header line carrying the reason and ring stats. Default dump location:
next to the configured events path when set, else the working directory.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
from collections import deque
from typing import Any, Dict, List, Optional

from mmlspark_tpu_torch.utils import config

_lock = threading.Lock()
_ring: "deque[Dict[str, Any]]" = deque(maxlen=256)
_ring_size = 256          # maxlen the deque was built with
_dropped = 0              # events evicted from the ring (lifetime)
_seq = itertools.count(1)  # dump-file uniquifier within one process


def size() -> int:
    """Configured ring capacity (0 = recorder off)."""
    try:
        return int(config.get("observability.flight_recorder_size"))
    except (TypeError, ValueError):
        return 0


def active() -> bool:
    """Is the recorder capturing? One cheap check for ``events.emit``."""
    return size() > 0


def record(event: Dict[str, Any]) -> None:
    """Append one event dict to the ring (no copy, no serialization —
    callers hand over a fresh dict they will not mutate)."""
    global _ring, _ring_size, _dropped
    n = size()
    if n <= 0:
        return
    with _lock:
        if n != _ring_size:
            # capacity changed under config: keep the newest events
            _ring = deque(_ring, maxlen=n)
            _ring_size = n
        if len(_ring) == _ring.maxlen:
            _dropped += 1
        _ring.append(event)


def snapshot() -> List[Dict[str, Any]]:
    """The ring's current contents, oldest first."""
    with _lock:
        return list(_ring)


def clear() -> None:
    """Empty the ring (tests / between scenarios)."""
    global _dropped
    with _lock:
        _ring.clear()
        _dropped = 0


def default_dump_path(reason: str = "incident") -> str:
    """``flightrec-<pid>-<n>.jsonl`` next to the events log when one is
    configured, else in the working directory."""
    events_path = str(config.get("observability.events_path") or "")
    parent = os.path.dirname(os.path.abspath(events_path)) if events_path \
        else os.getcwd()
    return os.path.join(parent,
                        f"flightrec-{os.getpid()}-{next(_seq)}.jsonl")


def dump(reason: str, path: Optional[str] = None) -> Optional[str]:
    """Write the ring to ``path`` (JSONL, header line first) and return
    the path, or None when the recorder is off or has captured nothing.
    Never raises — a failed dump must not mask the incident being dumped.
    """
    events = snapshot()
    if not events:
        return None
    if path is None:
        path = default_dump_path(reason)
    # lazy import: events.py imports this module at load time
    from mmlspark_tpu_torch.observability import events as _events
    header = {"ts": round(_events.wall(), 6),
              "type": "event", "name": "flightrec.dump", "reason": reason,
              "events": len(events), "dropped": _dropped,
              "capacity": _ring_size, "pid": os.getpid()}
    try:
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            f.write(json.dumps(header, sort_keys=True, default=str) + "\n")
            for e in events:
                f.write(json.dumps(e, sort_keys=True, default=str) + "\n")
    except OSError:
        return None
    return path
