"""The featurize pass's host stack: the mean ms a ``transform:
ImageFeaturizer`` inside the traced stretch spent in ``score:stack`` (the
residency build: coerce, pad and ``np.stack``; the port's program
spans)."""
from cardbench.program_spans import mean_ms_under


def read(rec):
    return mean_ms_under(rec, "transform:ImageFeaturizer", ["score:stack"])
