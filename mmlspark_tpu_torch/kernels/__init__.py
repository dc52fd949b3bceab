"""The port's hand-written Hopper kernels, one registered ``Kernel`` each.

Every Pallas TPU kernel of the JAX package that a ported path runs gets a
CUDA C++ counterpart here (``csrc/``), built by :mod:`.build`; so do the
routed MLP's index dispatch and expert GEMMs, which the JAX package leaves
to one-hot einsums. Each sits behind a wrapper in the module that uses it,
beside a plain PyTorch version of the same function; the wrapper launches
the kernel for a CUDA tensor and takes the plain version only for a CPU
tensor.
"""
from __future__ import annotations

from ctypes import c_float, c_int, c_longlong, c_void_p

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
# (src, dst, y0, y1, fy, x0, x1, fx, mean, istd, slots, stage_rows,
#  stage_n, b, hs, ws, hd, wd, c, band_rows, stage_max, staged, out_bf16,
#  stream); wrapper: ops/preprocess.py::crop_resize_normalize, which counts
# its two variants ("staged", "direct")
CROP_RESIZE_NORMALIZE = Kernel(
    "crop_resize_normalize", "crop_resize_normalize.cu",
    [c_void_p] * 13 + [c_int] * 10 + [c_void_p])

# K3: mmlspark_tpu/ops/pallas_attention.py::flash_attention (forward), two
# routes chosen by ops/attention.py::_route from dtype and head dim.
# (q, k, v, out, b, l, h, d, q/k/v strides over (b, l, h) in elements,
#  scale, causal, bf16, stream); wrapper: ops/attention.py::flash_attention
_K3_ARGTYPES = ([c_void_p] * 4 + [c_int] * 4 + [c_longlong] * 9
                + [c_float, c_int, c_int, c_void_p])
# the fp32 CUDA-core route: f32, and bf16 with D > 128
FLASH_ATTENTION = Kernel("flash_attention", "flash_attention.cu",
                         _K3_ARGTYPES)
# the tensor-core route (wgmma, TMA): bf16 with D <= 128; same signature
FLASH_ATTENTION_TC = Kernel("flash_attention_tc", "flash_attention_wgmma.cu",
                            _K3_ARGTYPES)

# The experts of a routed MLP (mmlspark_tpu_torch/ops/moe.py); no TPU
# counterpart: the JAX package routes by one-hot einsums.
# (a, b, c, c2, bias, aux, E, M, N, K, a_mn, b_mn, lda, sae, ldb, sbe, ldc,
#  sce, epi, stream); the wrapper counts its variants ("up", "down",
# "d_pre", "d_x", "d_w")
MOE_GROUPED_GEMM = Kernel(
    "moe_grouped_gemm", "moe_grouped_gemm.cu",
    [c_void_p] * 6 + [c_int] * 6 + [c_longlong] * 6 + [c_int, c_void_p])
# the index dispatch's row moves and the experts' bias gradient, four entry
# points of one source:
# (src, slot, dst, S, D, K, stream)
MOE_PERMUTE = Kernel("moe_permute", "moe_rows.cu",
                     [c_void_p] * 3 + [c_int] * 3 + [c_void_p])
# (src, slot, gates, dst, S, D, K, dst_f32, stream); the combine, and the
# gather's backward (variant "gather_bwd")
MOE_UNPERMUTE = Kernel("moe_unpermute", "moe_rows.cu",
                       [c_void_p] * 4 + [c_int] * 4 + [c_void_p])
# (dy, ye, slot, gates, d_ye, d_gates, S, D, K, stream)
MOE_UNPERMUTE_BWD = Kernel("moe_unpermute_bwd", "moe_rows.cu",
                           [c_void_p] * 6 + [c_int] * 3 + [c_void_p])
# (g, out, E, C, N, stream)
MOE_BIAS_GRAD = Kernel("moe_bias_grad", "moe_rows.cu",
                       [c_void_p] * 2 + [c_int] * 3 + [c_void_p])
