"""K2 (crop + resize + normalize) against its byte bound: the least bytes
its launches in the stretch must move (``counts.kernel_bytes.k2`` from
shapes, each launch weighted by the batch sizes the lane ran) at the
card's HBM peak, over the kernel's device time, in %."""
from cardbench.counts import kernel_bytes, peaks
from cardbench.metrics import kernel_time


def read(rec):
    n, secs = kernel_time(rec, "crop_resize_normalize")
    lane = rec["lane"]
    if not n or secs <= 0:
        return None
    s = rec["cfg"]["image_size"]

    def nbytes(b):
        return kernel_bytes.k2(b, lane["src"], (s, s), lane["out_bytes"])
    if "replays" in lane:
        total = sum(lane["replays"].values())
        if not total:
            return None
        per = sum(r * nbytes(b) for b, r in lane["replays"].items()) / total
    else:
        per = nbytes(lane["batch"])
    return 100.0 * n * per / peaks.HBM_BYTES_PER_S / secs
