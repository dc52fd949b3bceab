"""K1 (per-channel normalize) against its byte bound: each launch moves a
batch's uint8 images in and the same shape in the compute dtype out
(``counts.kernel_bytes.k1``), at the card's HBM peak, over the kernel's
device time, in %."""
from cardbench.counts import kernel_bytes, peaks
from cardbench.metrics import kernel_time


def read(rec):
    n, secs = kernel_time(rec, "fused_normalize_")
    lane = rec["lane"]
    if not n or secs <= 0:
        return None
    per = kernel_bytes.k1(lane["batch"], lane["image"], lane["out_bytes"])
    return 100.0 * n * per / peaks.HBM_BYTES_PER_S / secs
