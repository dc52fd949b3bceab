"""The host's time to enqueue a training step: the mean ms a
``train:step`` inside the traced stretch took outside its ``train:flush``
children, the counted ring read (the port's program spans; host spans
over asynchronous launches, not the device's time)."""
from cardbench.program_spans import children, dur, inside


def read(rec):
    steps = inside(rec, "train:step")
    if not steps:
        return None
    by_parent = children(rec)
    total = sum(dur(s) - sum(dur(c) for c in by_parent.get(s["span_id"], [])
                             if c["name"] == "train:flush")
                for s in steps)
    return 1e3 * total / len(steps)
