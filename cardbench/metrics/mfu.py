"""The whole step's share of the card's bf16 peak: the model FLOPs of the
images the lane finished in the traced stretch (``counts.flops``: a
forward, or three for a training step), over the seconds times the chips
and the peak, in %. The seconds are the stretch, or where the lane asks
for them (``over_busy``: a server, whose offered rate fixes its work a
second) the device's busy time in the stretch, from the trace."""
from cardbench.counts import flops, peaks


def read(rec):
    lane = rec["lane"]
    if not lane.get("images"):
        return None
    work = flops.forward(rec["cfg"]) * lane["images"] * (3 if lane["train"] else 1)
    secs = sum(rec["busy_s"]) / len(rec["busy_s"]) if lane.get("over_busy") \
        else rec["window_s"]
    if secs <= 0:
        return None
    return 100.0 * work / (secs * rec["chips"] * peaks.BF16_FLOPS)
