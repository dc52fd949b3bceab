"""The featurize pass's host prep: the mean ms a ``transform:
ImageFeaturizer`` inside the traced stretch spent in ``featurize:prep``
(the uint8 variants scan and the unroll; the port's program spans)."""
from cardbench.program_spans import mean_ms_under


def read(rec):
    return mean_ms_under(rec, "transform:ImageFeaturizer", ["featurize:prep"])
