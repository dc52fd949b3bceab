"""Metrics registry: counters, gauges, fixed-bucket histograms.

The port's minimal copy of ``mmlspark_tpu/observability/metrics.py``:
the instruments and the process-wide registry that the trainer, the
prefetcher, the metric logger and the server report to, the bucket
percentile estimator, and the Prometheus text exposition the HTTP front
end serves on ``/metrics``. Cold paths count unconditionally (an int add
under a lock); hot per-step paths gate on :func:`metrics_enabled`
(``observability.metrics``), so a run with it off pays nothing per step.
"""
from __future__ import annotations

import bisect
import re
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

from mmlspark_tpu_torch.utils import config

DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0)

# MFU denominator: the NVIDIA H100 SXM data sheet's dense (no sparsity)
# bf16 tensor-core peak, in FLOP/s
H100_SXM_BF16_DENSE_FLOPS = 989e12


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize(name: str) -> str:
    """Dotted registry name -> Prometheus-charset metric name."""
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def nearest_rank(sorted_vals: Sequence[float], p: float) -> float:
    """Nearest-rank percentile over raw ascending samples (0 when empty);
    histogram-backed percentiles go through :func:`percentile_from_buckets`
    instead."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1,
            max(0, int(round(p / 100.0 * (len(sorted_vals) - 1)))))
    return float(sorted_vals[i])


def percentile_from_buckets(cumulative: Dict[Any, Any], p: float) -> float:
    """Percentile (``p`` in [0, 100]) from a cumulative ``{le: count}``
    mapping with its ``+Inf`` slot: linear interpolation inside the bucket
    holding the target rank; a rank in the overflow bucket clamps to the
    highest finite bound. An empty histogram gives 0.0."""
    return percentile_from_buckets_ex(cumulative, p)[0]


def percentile_from_buckets_ex(cumulative: Dict[Any, Any],
                               p: float) -> Tuple[float, bool]:
    """:func:`percentile_from_buckets` and whether the rank landed in the
    ``+Inf`` overflow bucket (the value is then a floor, not an
    estimate)."""
    finite = []
    inf_count: Optional[float] = None
    for le, c in cumulative.items():
        if isinstance(le, str) and le.strip().lstrip("+") in ("Inf", "inf"):
            inf_count = float(c)
        elif float(le) == float("inf"):
            inf_count = float(c)
        else:
            finite.append((float(le), float(c)))
    finite.sort()
    total = inf_count if inf_count is not None else (
        finite[-1][1] if finite else 0.0)
    if total <= 0:
        return 0.0, False
    rank = max(0.0, min(100.0, float(p))) / 100.0 * total
    prev_bound, prev_cum = 0.0, 0.0
    for bound, cum in finite:
        if cum >= rank:
            span = cum - prev_cum
            frac = (rank - prev_cum) / span if span > 0 else 1.0
            return prev_bound + (bound - prev_bound) * frac, False
        prev_bound, prev_cum = bound, cum
    return (finite[-1][0] if finite else 0.0), bool(finite)


def escape_label_value(value: str) -> str:
    """A Prometheus label value with backslash, double quote and newline
    escaped, so a quoted name cannot break an exposition line."""
    return (str(value).replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def metrics_enabled() -> bool:
    """Gate for hot-path (per-step) collection."""
    return bool(config.get("observability.metrics"))


class Counter:
    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: inc({n}) must be >= 0")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Cumulative fixed-bucket histogram (Prometheus ``le`` semantics)."""

    __slots__ = ("name", "buckets", "_lock", "_counts", "_sum", "_count",
                 "_exemplar")

    def __init__(self, name: str, buckets: Sequence[float] = DEFAULT_BUCKETS):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(
                f"histogram {name}: buckets must be non-empty and ascending")
        self.name = name
        self.buckets = tuple(float(b) for b in buckets)
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf overflow
        self._sum = 0.0
        self._count = 0
        self._exemplar: Optional[Dict[str, Any]] = None

    def observe(self, v: float, exemplar: Optional[str] = None) -> None:
        """Count ``v``; ``exemplar`` (a request's trace id) is kept as the
        histogram's last exemplar."""
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if exemplar is not None:
                self._exemplar = {"trace_id": str(exemplar),
                                  "value": float(v)}

    @property
    def exemplar(self) -> Optional[Dict[str, Any]]:
        return self._exemplar

    def percentile(self, p: float) -> float:
        """Bucket-interpolated percentile, ``p`` in [0, 100]."""
        return percentile_from_buckets(self.cumulative(), p)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def cumulative(self) -> Dict[str, int]:
        """``{le: cumulative count}`` including the ``+Inf`` bucket."""
        out: Dict[str, int] = {}
        with self._lock:
            running = 0
            for b, c in zip(self.buckets, self._counts):
                running += c
                out[repr(b)] = running
            out["+Inf"] = running + self._counts[-1]
        return out


class MetricsRegistry:
    """Name -> instrument, created on first use; asking for a name under
    another instrument type is an error."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get(name, Histogram, buckets or DEFAULT_BUCKETS)

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            items = sorted(self._metrics.items())
        out: Dict[str, Any] = {}
        for name, m in items:
            if isinstance(m, Counter):
                out[name] = {"type": "counter", "value": m.value}
            elif isinstance(m, Gauge):
                out[name] = {"type": "gauge", "value": m.value}
            else:
                out[name] = {"type": "histogram", "count": m.count,
                             "sum": m.sum, "buckets": m.cumulative()}
                if m.exemplar is not None:
                    out[name]["exemplar"] = dict(m.exemplar)
        return out

    def prometheus_text(self) -> str:
        """Prometheus text-format exposition of every registered metric."""
        lines = []
        with self._lock:
            items = sorted(self._metrics.items())
        for name, m in items:
            pname = sanitize(name)
            if isinstance(m, Counter):
                lines += [f"# TYPE {pname} counter", f"{pname} {_fmt(m.value)}"]
            elif isinstance(m, Gauge):
                lines += [f"# TYPE {pname} gauge", f"{pname} {_fmt(m.value)}"]
            else:
                lines.append(f"# TYPE {pname} histogram")
                for le, c in m.cumulative().items():
                    lines.append(f'{pname}_bucket{{le="{le}"}} {c}')
                lines.append(f"{pname}_sum {_fmt(m.sum)}")
                lines.append(f"{pname}_count {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")


def _fmt(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(float(v))


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry all instrumentation reports to."""
    return _REGISTRY


def counter(name: str) -> Counter:
    return _REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return _REGISTRY.gauge(name)


def histogram(name: str,
              buckets: Optional[Sequence[float]] = None) -> Histogram:
    return _REGISTRY.histogram(name, buckets)
