"""Host<->device copies: the device time of every memcpy in the stretch,
per batch the lane ran, in ms."""


def read(rec):
    batches = rec["lane"].get("batches")
    copies = [d for n, _, _, d in rec["ops"] if n.startswith("Memcpy")]
    if not batches or not copies:
        return None
    return 1e3 * sum(copies) / batches
