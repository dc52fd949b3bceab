"""Operand precision of the reference's matmuls and convs."""
import contextlib

import torch

# float8 e4m3's largest finite value: a tensor is scaled so its largest
# magnitude lands there before rounding
E4M3_MAX = 448.0


def operand(t: torch.Tensor, mode: str) -> torch.Tensor:
    """``t`` as a matmul or conv operand in ``mode``: unchanged in fp32;
    in fp8, rounded to float8 e4m3 under one per-tensor scale, with the
    gradient passed straight through."""
    if mode == "fp32":
        return t
    if mode != "fp8":
        raise ValueError(f"unknown reference precision {mode!r}")
    x = t.detach()
    scale = x.abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return t + (q - x)


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for matmuls and cuDNN convs while the reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
