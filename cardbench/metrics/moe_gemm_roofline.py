"""The experts' grouped GEMM against the bf16 peak: the expert GEMM FLOPs
of the traced steps' images (``counts/<family>.py::expert_gemm_flops``,
over every routed pair), over the device seconds of the kernels named
``moe_grouped_gemm``, in %. None where no such kernel ran or the family
counts no expert GEMMs."""
from cardbench.counts import peaks
from cardbench.harness import family_module
from cardbench.metrics import kernel_time


def read(rec):
    n, secs = kernel_time(rec, "moe_grouped_gemm")
    images = rec["lane"].get("images")
    count = getattr(family_module("counts", rec["cfg"]), "expert_gemm_flops",
                    None)
    if not n or secs <= 0 or not images or count is None:
        return None
    return 100.0 * count(rec["cfg"], images) / (secs * peaks.BF16_FLOPS)
