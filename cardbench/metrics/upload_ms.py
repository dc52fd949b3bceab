"""The host's side of the featurize pass's upload: the mean ms a
``transform:ImageFeaturizer`` inside the traced stretch spent in
``score:upload`` (the pageable ``.to(device)``; the device's side is
``copy_ms``; the port's program spans)."""
from cardbench.program_spans import mean_ms_under


def read(rec):
    return mean_ms_under(rec, "transform:ImageFeaturizer", ["score:upload"])
