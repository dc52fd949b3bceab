"""The serving executor's host work a batch: the mean ms a ``serve:batch``
inside the traced stretch spent in ``batch:take``, ``batch:pad``,
``batch:copy_in`` and ``batch:respond`` (the port's program spans; the
replay's launch and the fetch's wait left out)."""
from cardbench.program_spans import mean_ms_under


def read(rec):
    return mean_ms_under(rec, "serve:batch", [
        "batch:take", "batch:pad", "batch:copy_in", "batch:respond"])
