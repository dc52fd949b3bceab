"""Run reports: the event-log reader.

The port of ``mmlspark_tpu/observability/report.py``, its first part:
:func:`load_events`, which ``observability/aggregate.py`` merges fleet
logs with. The report's sections and renderers are a later slice of the
port (ROADMAP queue A, observability).
"""
from __future__ import annotations

import json
from typing import Any, Dict, List

from mmlspark_tpu_torch.observability import metrics
from mmlspark_tpu_torch.utils.logging import get_logger


def load_events(path: str) -> List[Dict[str, Any]]:
    """Parse a JSON-lines event log; malformed lines are counted and
    skipped (a killed process tears its final line mid-write), not fatal.
    Every skipped line increments the ``events.torn_lines`` counter so a
    merged fleet view quantifies its own data loss."""
    events: List[Dict[str, Any]] = []
    bad = 0
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                bad += 1
    if bad:
        metrics.counter("events.torn_lines").inc(bad)
        get_logger("observability.report").warning(
            "%s: skipped %d torn/malformed line(s)", path, bad)
    return events
