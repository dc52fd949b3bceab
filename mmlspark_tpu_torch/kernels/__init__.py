"""The port's hand-written Hopper kernels, one registered ``Kernel`` each.

Every Pallas TPU kernel of the JAX package that a ported path runs gets a
CUDA C++ counterpart here (``csrc/``), built by :mod:`.build`. Each sits
behind a wrapper in the module that uses it, beside a plain PyTorch version
of the same function; the wrapper launches the kernel for a CUDA tensor and
takes the plain version only for a CPU tensor.
"""
from __future__ import annotations

from ctypes import c_int, c_longlong, c_void_p

from mmlspark_tpu_torch.kernels.build import (  # noqa: F401
    KERNELS, Kernel, build_all, reset_launches,
)

# K1: mmlspark_tpu/ops/pallas_preprocess.py::fused_normalize.
# (src, dst, mean, inv_std, total, c, out_bf16, stream); wrapper:
# ops/preprocess.py::fused_normalize
FUSED_NORMALIZE = Kernel(
    "fused_normalize", "fused_normalize.cu",
    [c_void_p] * 4 + [c_longlong, c_int, c_int, c_void_p])

# K2: mmlspark_tpu/ops/pallas_preprocess.py::_fused_crop_resize_normalize.
# (src, dst, y0, y1, fy, x0, x1, fx, mean, istd, b, hs, ws, hd, wd, c,
#  out_bf16, stream); wrapper: ops/preprocess.py::crop_resize_normalize
CROP_RESIZE_NORMALIZE = Kernel(
    "crop_resize_normalize", "crop_resize_normalize.cu",
    [c_void_p] * 10 + [c_int] * 7 + [c_void_p])
