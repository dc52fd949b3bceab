"""Control plane: close the loop from fleet signals to fleet levers.

The observability stack (scraper, SLO engine, HBM ledger) senses;
``serve/`` exposes the levers (router weights, replica lifecycle,
admission quotas, rollout abort); this package is the part that DECIDES.
See :mod:`mmlspark_tpu_torch.control.autopilot`.
"""
from mmlspark_tpu_torch.control.autopilot import (  # noqa: F401
    Autopilot, AutopilotPolicy, AutopilotState, decide, fleet_signals,
)

__all__ = ["Autopilot", "AutopilotPolicy", "AutopilotState", "decide",
           "fleet_signals"]
