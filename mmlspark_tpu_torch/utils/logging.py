"""Logging and train-loop metrics.

The port's copy of ``mmlspark_tpu/utils/logging.py``. Every logger of the
port hangs off the ``mmlspark_tpu_torch`` root, with the level from
``logging.level``. :class:`MetricLogger` logs step / loss / examples-per-sec
at a cadence; off-cadence calls cost nothing, and an on-cadence call
fetches its device values through one counted sync (``train.log``), so a
log line is a visible host round trip, never a hidden one.
"""
from __future__ import annotations

import logging
import sys
from collections import deque
from typing import Any, Dict, Optional

from mmlspark_tpu_torch.utils import config

_ROOT = "mmlspark_tpu_torch"
_configured = False


def get_logger(name: str = "") -> logging.Logger:
    """Logger under the port's root (``mmlspark_tpu_torch.<name>``)."""
    global _configured
    if not _configured:
        root = logging.getLogger(_ROOT)
        if not root.handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(logging.Formatter(
                "%(asctime)s %(levelname)s %(name)s: %(message)s",
                datefmt="%H:%M:%S"))
            root.addHandler(handler)
        root.setLevel(config.get("logging.level"))
        root.propagate = False
        _configured = True
    return logging.getLogger(f"{_ROOT}.{name}" if name else _ROOT)


def set_level(level: str) -> None:
    """Set ``logging.level`` and the port's root logger to ``level``."""
    config.set("logging.level", level)
    logging.getLogger(_ROOT).setLevel(level)


class MetricLogger:
    """Throttled train-loop metrics: step, loss, examples/sec.

    On cadence (``step % every == 0``) it fetches the values (one counted
    sync for all of them), computes throughput over the interval, logs,
    keeps a bounded history (``logging.history_max``), and forwards to the
    registry gauges ``train.<name>`` and, when the event log is on, a
    ``train.step`` event. The throughput baseline is set by the first call,
    so the first interval does not include the first step's set-up."""

    def __init__(self, every: Optional[int] = None, name: str = "train",
                 history_max: Optional[int] = None):
        self.every = (config.get("logging.metrics_every")
                      if every is None else every)
        self.log = get_logger(name)
        self.history: deque = deque(maxlen=(
            config.get("logging.history_max")
            if history_max is None else history_max))
        self._last_time: Optional[float] = None
        self._rows_since = 0

    def __call__(self, step: int, metrics: Dict[str, Any],
                 batch_rows: int = 0) -> None:
        self._rows_since += batch_rows
        if not self.every or step % self.every != 0:
            return
        import torch
        from mmlspark_tpu_torch.observability import (
            events, metrics as obsmetrics, syncs,
        )
        now = events.perf()
        rate = (0.0 if self._last_time is None
                else self._rows_since / max(now - self._last_time, 1e-9))
        dev = {k: v for k, v in metrics.items()
               if isinstance(v, torch.Tensor)}
        host = syncs.device_get(dev, "train.log") if dev else {}
        vals = {k: float(host.get(k, v)) for k, v in metrics.items()}
        self.history.append({"step": step, **vals, "examples_per_sec": rate})
        body = " ".join(f"{k}={v:.5g}" for k, v in vals.items())
        self.log.info("step %d %s examples/sec=%.1f", step, body, rate)
        for k, v in vals.items():
            obsmetrics.gauge(f"train.{k}").set(v)
        obsmetrics.gauge("train.examples_per_sec").set(rate)
        if events.events_enabled():
            events.emit("metric", "train.step", step=step,
                        examples_per_sec=round(rate, 3), values=vals)
        self._last_time = now
        self._rows_since = 0
