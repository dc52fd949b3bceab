"""The featurize pass's wait on the device: the mean ms a ``transform:
ImageFeaturizer`` inside the traced stretch spent in ``score:fetch``, the
host blocked until the device's work and the copy back ended (the port's
program spans)."""
from cardbench.program_spans import mean_ms_under


def read(rec):
    return mean_ms_under(rec, "transform:ImageFeaturizer", ["score:fetch"])
