"""Least bytes a preprocessing kernel call must move: each input byte read
once, each output byte written once."""


def k2(batch: int, src_hwc, dst_hw, out_bytes: int = 2) -> int:
    """Crop + resize + normalize: uint8 (B, Hs, Ws, C) in, (B, Hd, Wd, C)
    of ``out_bytes`` out."""
    hs, ws, c = src_hwc
    return batch * (hs * ws * c + dst_hw[0] * dst_hw[1] * c * out_bytes)


def k1(batch: int, hwc, out_bytes: int = 2) -> int:
    """Per-channel normalize: uint8 (B, H, W, C) in, the same shape of
    ``out_bytes`` out."""
    h, w, c = hwc
    return batch * h * w * c * (1 + out_bytes)
