"""Per-layer readers, one file per metric (``<metric>.py``) or per quantity
(``<part before the first dot>.py``). Each gives ``read(rec)``: the number
from the traced stretch's record, or None when there is nothing to read.
``rec`` holds ``window_s``, ``busy_s`` (per device), ``ops`` [(name,
device, start_s, dur_s)], ``spans``, ``lane`` (the lane's counts over the
stretch), ``cfg``, ``traffic`` and ``chips``."""


def kernel_time(rec, part: str):
    """(launches, seconds) of the device kernels whose name holds ``part``
    (the library's empty timing kernel left out)."""
    hits = [d for n, _, _, d in rec["ops"] if part in n and "empty" not in n]
    return len(hits), sum(hits)
