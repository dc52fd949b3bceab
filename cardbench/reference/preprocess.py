"""Plain uint8 image preprocessing, written from the published semantics.

- ``crop_resize_normalize``: center crop (integer offsets), bilinear resize
  with half-pixel centers and clamping at the source border, the result
  rounded half to even and clipped to 0..255 as a uint8 image would be,
  then ``(z - mean[c]) / std[c]``; rows are blended first, then columns,
  in float32.
- ``normalize``: ``(x - mean[c]) * (1 / std[c])`` with the reciprocal taken
  once in float32.
"""
import numpy as np
import torch


def _taps(src: int, dst: int, offset: int, size: int):
    s = offset + (np.arange(dst) + 0.5) * size / dst - 0.5
    i0 = np.clip(np.floor(s).astype(np.int64), 0, src - 1)
    i1 = np.clip(i0 + 1, 0, src - 1)
    frac = np.clip(s - i0, 0.0, 1.0).astype(np.float32)
    return i0, i1, frac


def crop_resize_normalize(u8: torch.Tensor, dst_hw, crop_hw=None,
                          mean=(0.0,), std=(1.0,)) -> torch.Tensor:
    """uint8 (B, Hs, Ws, C) -> float32 (B, Hd, Wd, C)."""
    _, hs, ws, c = u8.shape
    ch, cw = crop_hw if crop_hw else (hs, ws)
    dev = u8.device
    ty = [torch.from_numpy(a).to(dev) for a in
          _taps(hs, dst_hw[0], (hs - ch) // 2, ch)]
    tx = [torch.from_numpy(a).to(dev) for a in
          _taps(ws, dst_hw[1], (ws - cw) // 2, cw)]
    x = u8.float()
    wy = ty[2][None, :, None, None]
    rows = x.index_select(1, ty[0]) * (1 - wy) + x.index_select(1, ty[1]) * wy
    wx = tx[2][None, None, :, None]
    z = rows.index_select(2, tx[0]) * (1 - wx) + rows.index_select(2, tx[1]) * wx
    z = z.round().clamp(0.0, 255.0)
    m = torch.as_tensor(np.broadcast_to(np.asarray(mean, np.float32), (c,)).copy(),
                        device=dev)
    s = torch.as_tensor(np.broadcast_to(np.asarray(std, np.float32), (c,)).copy(),
                        device=dev)
    return (z - m) / s


def normalize(u8: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 (..., C) -> float32, per channel."""
    c = u8.shape[-1]
    m = torch.as_tensor(np.broadcast_to(np.asarray(mean, np.float32), (c,)).copy(),
                        device=u8.device)
    inv = (np.float32(1.0) / np.broadcast_to(np.asarray(std, np.float32), (c,))
           ).astype(np.float32)
    return (u8.float() - m) * torch.as_tensor(inv, device=u8.device)
