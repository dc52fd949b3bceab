"""The device's idle share: the part of the traced stretch in which no
operation ran on it, averaged over the chips, in %."""


def read(rec):
    w = rec["window_s"]
    busy = sum(rec["busy_s"]) / len(rec["busy_s"])
    if w <= 0 or busy <= 0:
        return None
    return 100.0 * (w - busy) / w
