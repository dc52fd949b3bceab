"""Wall-time spans with a context-propagated parent stack.

The port of ``mmlspark_tpu/observability/spans.py``. ``span(kind,
detail)`` times a region and emits one ``"span"`` event on exit, carrying
its ``span_id``, ``pid``, its parent's id and name, and its depth: enough
to rebuild the nesting tree offline (``mmlspark-tpu-torch report``,
``observability/trace.py``). The stack lives in a
``contextvars.ContextVar``, so threads and async tasks each see their own
ancestry.

A span has three sinks: the events log (``observability.events_path``),
the flight recorder's ring (on by default) and the in-memory collector
(:func:`collect_start` .. :func:`collect_stop`), which keeps a run's spans
for the run to read back on ``time.time_ns()``, the clock
``torch.profiler`` stamps device activity with, beside the thread CPU
time each span covered.

Hot spans (``span(..., hot=True)``) mark the per-frame, per-batch and
per-step boundaries of the featurize pass, the serving executor and the
train step. They are live only while the collector is on or the events
log is set, and never enter the ring: at hundreds a second they would push
out the incidents the ring keeps.

Cost: which sinks are live is cached in module flags (:func:`refresh`,
called on ``config.set``/``unset`` of the keys in :data:`WATCHED`, by a
full read in ``events`` that finds the cache stale, and by the collector's
start and stop), so with no sink live :func:`span` returns the shared
no-op after one flag read, before any string is built. With
``observability.annotate`` on, the span also opens
``torch.profiler.record_function`` (``utils.profiling.annotate``), so the
same names mark a ``torch.profiler`` trace.
"""
from __future__ import annotations

import contextvars
import itertools
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from mmlspark_tpu_torch.observability import events, flightrec
from mmlspark_tpu_torch.utils import config

# (name, span_id) ancestry of the current context; () at the root
_STACK: contextvars.ContextVar[Tuple[Tuple[str, int], ...]] = \
    contextvars.ContextVar("mmlspark_tpu_torch_span_stack", default=())
_ids = itertools.count(1)
_ids_lock = threading.Lock()

WATCHED = ("observability.events_path", "observability.annotate",
           "observability.flight_recorder_size")

# the sink state, cached by refresh(): a span has a sink (_LIVE), a hot
# span has one (_HOT), spans open a profiler annotation (_ANNOTATE), the
# events log is set (_LOG), an event has a sink: log or ring (_RECORDING)
_LIVE = _HOT = _ANNOTATE = _LOG = _RECORDING = False

_collect_lock = threading.Lock()
_collected: Optional[List[Dict[str, Any]]] = None   # None: collector off
_capacity = 0
_dropped = 0


def refresh() -> None:
    """Re-read which sinks are live into the flags every :func:`span` and
    ``syncs.sync_point`` check. An environment key changed after import
    is seen here, or at the next ``events.recording_enabled()`` /
    ``events_enabled()``."""
    global _LIVE, _HOT, _ANNOTATE, _LOG, _RECORDING
    annotate = bool(config.get("observability.annotate"))
    log = bool(config.get("observability.events_path"))
    ring = flightrec.active()
    collect = _collected is not None
    _ANNOTATE, _LOG, _RECORDING = annotate, log, log or ring
    _HOT = annotate or log or collect
    _LIVE = _HOT or ring


def _on_config(key: str) -> None:
    if key in WATCHED:
        refresh()


config.on_change(_on_config)


def recording() -> bool:
    """The cached ``events.recording_enabled()``: the log or the ring."""
    return _RECORDING


def collect_start(capacity: int = 1 << 20) -> None:
    """Turn the collector on, empty, holding at most ``capacity`` spans
    (later ones are counted as dropped)."""
    global _collected, _capacity, _dropped
    with _collect_lock:
        _collected, _capacity, _dropped = [], int(capacity), 0
    refresh()


def collect_stop() -> Tuple[List[Dict[str, Any]], int]:
    """Turn the collector off: (the spans that closed while it was on, in
    the order they closed; how many were dropped past its capacity).
    Each span is ``{name, span_id, parent_id, thread, start_ns, end_ns,
    cpu_ns, attrs}``: ``start_ns``/``end_ns`` on ``time.time_ns()`` (the
    injected wall clock under ``events.set_clock``), ``cpu_ns`` the
    thread CPU time between them. Nothing when it was off."""
    global _collected
    with _collect_lock:
        out, _collected = _collected, None
        dropped = _dropped
    refresh()
    return (out or []), dropped


def _collect(record: Dict[str, Any]) -> None:
    global _dropped
    with _collect_lock:
        if _collected is None:
            return
        if len(_collected) < _capacity:
            _collected.append(record)
        else:
            _dropped += 1


def next_span_id() -> int:
    """A span id from the process counter, unique within the process
    (span events carry the pid beside it, and readers key on
    ``(pid, span_id)``)."""
    with _ids_lock:
        return next(_ids)


class _NoopSpan:
    """The shared span of the disabled path: nothing allocated per use."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def set(self, **attrs: Any) -> None:
        pass

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("name", "attrs", "span_id", "hot", "_emit", "_token",
                 "_start_wall", "_start_perf", "_start_ns", "_start_cpu",
                 "_parent", "_depth", "_annotation")

    def __init__(self, name: str, attrs: dict, hot: bool):
        self.name = name
        self.attrs = attrs
        self.hot = hot
        # an event on exit: hot spans go to the log alone
        self._emit = _LOG if hot else _RECORDING
        self.span_id = next_span_id()
        self._annotation = None
        if _ANNOTATE:
            from mmlspark_tpu_torch.utils.profiling import annotate as _ann
            self._annotation = _ann(name)

    def set(self, **attrs: Any) -> None:
        """Add ``attrs`` counted inside the span (they ride on its exit)."""
        self.attrs.update(attrs)

    def __enter__(self) -> "_Span":
        stack = _STACK.get()
        self._parent = stack[-1] if stack else None
        self._depth = len(stack)
        self._token = _STACK.set(stack + ((self.name, self.span_id),))
        if self._emit:
            self._start_wall = events.wall()
            self._start_perf = events.perf()
        if _collected is not None:
            self._start_ns = events.wall_ns()
            self._start_cpu = time.thread_time_ns()
        if self._annotation is not None:
            self._annotation.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._annotation is not None:
            self._annotation.__exit__(exc_type, exc, tb)
        _STACK.reset(self._token)
        parent_id = self._parent[1] if self._parent else None
        if _collected is not None and hasattr(self, "_start_ns"):
            cpu_ns = time.thread_time_ns() - self._start_cpu
            _collect({"name": self.name, "span_id": self.span_id,
                      "parent_id": parent_id,
                      "thread": threading.get_ident(),
                      "start_ns": self._start_ns, "end_ns": events.wall_ns(),
                      "cpu_ns": cpu_ns, "attrs": self.attrs})
        if not self._emit:
            return False
        dur = events.perf() - self._start_perf
        fields = {
            "span_id": self.span_id,
            "pid": os.getpid(),
            "parent_id": parent_id,
            "parent": self._parent[0] if self._parent else "",
            "depth": self._depth,
            "start": round(self._start_wall, 6),
            "dur_s": round(dur, 9),
        }
        if exc_type is not None:
            fields["error"] = exc_type.__name__
        if self.attrs:
            fields["attrs"] = self.attrs
        events.emit("span", self.name, ring=not self.hot, **fields)
        return False


def span(kind: str, detail: str = "", *, hot: bool = False, **attrs: Any):
    """Context manager timing ``kind[:detail]`` (e.g. ``span("fit",
    "Featurize")`` -> ``fit:Featurize``). Returns the shared no-op when
    no sink takes it; ``attrs`` ride on the emitted event and the
    collected record (keep them small and JSON-friendly). ``hot`` marks a
    per-frame, per-batch or per-step span: it skips the flight
    recorder's ring, and inside an open span of its own name (a stage
    that a ``Pipeline`` already spans) it is not opened again."""
    if not (_HOT if hot else _LIVE):
        return _NOOP
    name = f"{kind}:{detail}" if detail else kind
    if hot:
        stack = _STACK.get()
        if stack and stack[-1][0] == name:
            return _NOOP
    return _Span(name, attrs, hot)


def current_span() -> Optional[Tuple[str, int]]:
    """(name, span_id) of the innermost open span, or None at the root."""
    stack = _STACK.get()
    return stack[-1] if stack else None


refresh()
