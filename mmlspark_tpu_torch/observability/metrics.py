"""Metrics registry: counters, gauges, fixed-bucket histograms.

The port's minimal copy of ``mmlspark_tpu/observability/metrics.py``:
the instruments and the process-wide registry that the trainer, the
prefetcher and the metric logger report to. Cold paths count
unconditionally (an int add under a lock); hot per-step paths gate on
:func:`metrics_enabled` (``observability.metrics``), so a run with it off
pays nothing per step. The Prometheus exposition and the percentile
helpers of the reference are not ported yet (ROADMAP, observability).
"""
from __future__ import annotations

import bisect
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

from mmlspark_tpu_torch.utils import config

DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0)

# MFU denominator: the NVIDIA H100 SXM data sheet's dense (no sparsity)
# bf16 tensor-core peak, in FLOP/s
H100_SXM_BF16_DENSE_FLOPS = 989e12


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

    __slots__ = ("name", "buckets", "_lock", "_counts", "_sum", "_count")

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

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

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
        return out


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
