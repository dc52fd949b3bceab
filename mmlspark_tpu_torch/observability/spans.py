"""Wall-time spans with a context-propagated parent stack.

The port of ``mmlspark_tpu/observability/spans.py``. ``span(kind,
detail)`` times a region and emits one ``"span"`` event on exit, carrying
its ``span_id``, ``pid``, its parent's id and name, and its depth: enough
to rebuild the nesting tree offline (``mmlspark-tpu-torch report``,
``observability/trace.py``). The stack lives in a
``contextvars.ContextVar``, so threads and async tasks each see their own
ancestry.

Cost: when no sink is live (no ``observability.events_path``, the flight
recorder off) and ``observability.annotate`` is off, :func:`span` returns
a shared no-op before any string is built. The flight recorder is on by
default, so by default every span is timed and recorded in its ring. With
``observability.annotate`` on, the span also opens
``torch.profiler.record_function`` (``utils.profiling.annotate``), so the
same names mark a ``torch.profiler`` trace.
"""
from __future__ import annotations

import contextvars
import itertools
import os
import threading
from typing import Any, Optional, Tuple

from mmlspark_tpu_torch.observability import events
from mmlspark_tpu_torch.utils import config

# (name, span_id) ancestry of the current context; () at the root
_STACK: contextvars.ContextVar[Tuple[Tuple[str, int], ...]] = \
    contextvars.ContextVar("mmlspark_tpu_torch_span_stack", default=())
_ids = itertools.count(1)
_ids_lock = threading.Lock()


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

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("name", "attrs", "span_id", "_token", "_start_wall",
                 "_start_perf", "_parent", "_depth", "_annotation")

    def __init__(self, name: str, attrs: dict, annotate: bool):
        self.name = name
        self.attrs = attrs
        self.span_id = next_span_id()
        self._annotation = None
        if annotate:
            from mmlspark_tpu_torch.utils.profiling import annotate as _ann
            self._annotation = _ann(name)

    def __enter__(self) -> "_Span":
        stack = _STACK.get()
        self._parent = stack[-1] if stack else None
        self._depth = len(stack)
        self._token = _STACK.set(stack + ((self.name, self.span_id),))
        self._start_wall = events.wall()
        self._start_perf = events.perf()
        if self._annotation is not None:
            self._annotation.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._annotation is not None:
            self._annotation.__exit__(exc_type, exc, tb)
        dur = events.perf() - self._start_perf
        _STACK.reset(self._token)
        fields = {
            "span_id": self.span_id,
            "pid": os.getpid(),
            "parent_id": self._parent[1] if self._parent else None,
            "parent": self._parent[0] if self._parent else "",
            "depth": self._depth,
            "start": round(self._start_wall, 6),
            "dur_s": round(dur, 9),
        }
        if exc_type is not None:
            fields["error"] = exc_type.__name__
        if self.attrs:
            fields["attrs"] = self.attrs
        events.emit("span", self.name, **fields)
        return False


def span(kind: str, detail: str = "", **attrs: Any):
    """Context manager timing ``kind[:detail]`` (e.g. ``span("fit",
    "Featurize")`` -> ``fit:Featurize``). Returns the shared no-op when
    every sink is off; ``attrs`` ride on the emitted event (keep them
    small and JSON-friendly)."""
    annotate = bool(config.get("observability.annotate"))
    if not (annotate or events.recording_enabled()):
        return _NOOP
    return _Span(f"{kind}:{detail}" if detail else kind, attrs, annotate)


def current_span() -> Optional[Tuple[str, int]]:
    """(name, span_id) of the innermost open span, or None at the root."""
    stack = _STACK.get()
    return stack[-1] if stack else None
