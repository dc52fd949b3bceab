"""The dispatch's row moves against the HBM peak: the least bytes of the
traced steps' gathers and combines, forward and backward, whatever the
routing (``counts/<family>.py::permute_bytes``), over the device seconds
of the kernels named ``moe_permute`` or ``moe_unpermute``, in %. None
where no such kernel ran or the family counts no row moves."""
from cardbench.counts import peaks
from cardbench.harness import family_module
from cardbench.metrics import kernel_time


def read(rec):
    n_in, s_in = kernel_time(rec, "moe_permute")
    n_out, s_out = kernel_time(rec, "moe_unpermute")
    secs = s_in + s_out
    images = rec["lane"].get("images")
    count = getattr(family_module("counts", rec["cfg"]), "permute_bytes", None)
    if not n_in + n_out or secs <= 0 or not images or count is None:
        return None
    return 100.0 * count(rec["cfg"], images) / (secs * peaks.HBM_BYTES_PER_S)
