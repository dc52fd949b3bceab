"""Minimal spans: a context-propagated stack of named regions.

The port's stand-in for ``mmlspark_tpu/observability/spans.py``. It keeps
the call-site API (``span(kind, detail, **attrs)`` and
:func:`current_span`) and the ``contextvars`` parent stack, so threads and
async tasks each see their own ancestry, but it has no event sink: nothing
is timed or emitted. The full observability layer is a later slice.
"""
from __future__ import annotations

import contextvars
import itertools
import threading
from typing import Any, Optional, Tuple

_ids = itertools.count(1)
_ids_lock = threading.Lock()

_STACK: contextvars.ContextVar[Tuple[str, ...]] = \
    contextvars.ContextVar("mmlspark_tpu_torch_span_stack", default=())


class _Span:
    __slots__ = ("name", "_token")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Span":
        self._token = _STACK.set(_STACK.get() + (self.name,))
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        _STACK.reset(self._token)
        return False


def span(kind: str, detail: str = "", **attrs: Any) -> _Span:
    """Context manager naming the region ``kind[:detail]`` (e.g.
    ``span("fit", "Featurize")`` -> ``fit:Featurize``). ``attrs`` are
    accepted for call-site parity with the reference and dropped."""
    return _Span(f"{kind}:{detail}" if detail else kind)


def current_span() -> Optional[str]:
    """Name of the innermost open span, or None at the root."""
    stack = _STACK.get()
    return stack[-1] if stack else None


def next_span_id() -> int:
    """A span id from the process counter, unique within the process
    (span events carry the pid beside it)."""
    with _ids_lock:
        return next(_ids)
