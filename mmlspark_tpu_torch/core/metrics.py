"""Typed metric records: the reference's MetricData.

The port's copy of ``mmlspark_tpu/core/metrics.py``: a scalar
``MetricValue`` and a named 2-D ``MetricTable`` (a confusion matrix, a
ROC curve), both logged through the port's logger and forwarded to the
metrics registry and the event log.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np


@dataclass(frozen=True)
class MetricValue:
    name: str
    value: float
    model_uid: str = ""

    def log(self, logger=None) -> None:
        """Log, set the gauge ``metrics.<name>``, and emit a ``metric``
        event when the event log is on."""
        from mmlspark_tpu_torch.observability import events
        from mmlspark_tpu_torch.observability import metrics as obsmetrics
        from mmlspark_tpu_torch.utils.logging import get_logger
        (logger or get_logger("metrics")).info(
            "metric %s=%.6g%s", self.name, self.value,
            f" model={self.model_uid}" if self.model_uid else "")
        obsmetrics.gauge(f"metrics.{self.name}").set(self.value)
        if events.events_enabled():
            events.emit("metric", self.name, value=self.value,
                        model=self.model_uid)


@dataclass(frozen=True)
class MetricTable:
    name: str
    columns: Sequence[str]
    rows: Any  # (n, len(columns)) array-like
    model_uid: str = ""

    def log(self, logger=None) -> None:
        from mmlspark_tpu_torch.observability import events
        from mmlspark_tpu_torch.utils.logging import get_logger
        arr = np.asarray(self.rows)
        (logger or get_logger("metrics")).info(
            "metric table %s (%d rows x %s)%s", self.name, len(arr),
            list(self.columns),
            f" model={self.model_uid}" if self.model_uid else "")
        if events.events_enabled():
            events.emit("metric", self.name, rows=int(len(arr)),
                        columns=list(self.columns), model=self.model_uid)


def create(name: str, value: float, model_uid: str = "") -> MetricValue:
    """``MetricData.create`` parity."""
    return MetricValue(name, float(value), model_uid)


def create_table(name: str, columns: Sequence[str], rows: Any,
                 model_uid: str = "") -> MetricTable:
    """``MetricData.createTable`` parity."""
    return MetricTable(name, list(columns), rows, model_uid)
