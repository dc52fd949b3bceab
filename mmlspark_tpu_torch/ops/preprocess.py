"""Device image preprocessing: normalize, and crop + resize + normalize.

The port of ``mmlspark_tpu/ops/pallas_preprocess.py``. There, uint8 images
went through two Pallas TPU kernels; here each is a CUDA kernel written by
hand for Hopper, behind a wrapper beside its plain torch version:

- K1, :func:`fused_normalize` (``kernels/csrc/fused_normalize.cu``): the
  per-channel normalize the training path runs inside its loss, built by
  :func:`make_preprocess_fn`; plain version :func:`_fused_normalize_plain`;
- K2, :func:`crop_resize_normalize`
  (``kernels/csrc/crop_resize_normalize.cu``): the scoring path's
  crop + resize + normalize; plain version
  :func:`_crop_resize_normalize_plain`.

A CUDA tensor launches the kernel (or raises: there is no fallback); a CPU
tensor takes the plain version. ``chip_smoke.py`` holds each kernel
against its plain version on the card.

The sampling convention is the reference's ``_sampling_matrix``: half-pixel
centers, the center-crop offset folded into the grid, clamping at the
SOURCE border (so crop edges may sample just outside the window, as
``tests/test_image.py`` records for the reference). Each row of that matrix
has at most two nonzeros, so the port keeps the taps ``(i0, i1, frac)``
instead of the matrix and lerps directly.

After the resize the values are requantized like the host path
(``image/ops.py``: round half to even, clip to 0..255), then normalized as
``(z - mean[c]) * (1 / std[c])``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.kernels import CROP_RESIZE_NORMALIZE, FUSED_NORMALIZE


def _inv_std(std) -> np.ndarray:
    """fp32 reciprocal of ``std`` as the reference computes it: the
    division is done once on the host, in float32."""
    return (1.0 / np.asarray(std, np.float32)).astype(np.float32)


def fused_normalize(u8: torch.Tensor, mean: torch.Tensor,
                    inv_std: torch.Tensor,
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """K1: uint8 ``u8`` whose last axis (or flat index, modulo C) is the
    channel -> ``(float(u8) - mean[c]) * inv_std[c]`` in ``out_dtype``,
    same shape. ``mean`` and ``inv_std`` are C-length float32 tensors on
    ``u8``'s device.

    A CUDA tensor launches the hand-written kernel; a CPU tensor takes the
    plain version. Anything the kernel does not take raises, before any
    launch is counted."""
    if u8.dtype != torch.uint8:
        raise TypeError(f"fused_normalize wants uint8, got {u8.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_normalize: out_dtype {out_dtype} is neither "
                        "float32 nor bfloat16")
    if u8.device.type == "cpu":
        return _fused_normalize_plain(u8, mean, inv_std, out_dtype)
    if u8.device.type != "cuda":
        raise ValueError(f"fused_normalize: no kernel for device {u8.device}")
    c = mean.numel()
    for t in (mean, inv_std):
        if t.device != u8.device or t.dtype != torch.float32 \
                or t.numel() != c or not t.is_contiguous():
            raise ValueError("fused_normalize: mean and inv_std must be "
                             "contiguous float32 of one length on the "
                             "input's device")
    if u8.numel() % c or (u8.dim() > 1 and u8.shape[-1] % c):
        raise ValueError(f"fused_normalize: {tuple(u8.shape)} does not hold "
                         f"whole groups of {c} channels")
    if not u8.is_contiguous():
        raise ValueError("fused_normalize wants a contiguous batch")
    out = torch.empty(u8.shape, dtype=out_dtype, device=u8.device)
    with torch.cuda.device(u8.device):
        stream = torch.cuda.current_stream(u8.device).cuda_stream
        FUSED_NORMALIZE(u8.data_ptr(), out.data_ptr(), mean.data_ptr(),
                        inv_std.data_ptr(), u8.numel(), c,
                        int(out_dtype == torch.bfloat16), stream,
                        variant=_k1_variant(u8.data_ptr()))
    return out


def _k1_variant(data_ptr: int) -> str:
    """The kernel K1's entry point launches for an input at ``data_ptr``:
    16-byte groups from an aligned input, else one element per thread."""
    return "vector" if data_ptr % 16 == 0 else "scalar"


def _fused_normalize_plain(u8: torch.Tensor, mean: torch.Tensor,
                           inv_std: torch.Tensor,
                           out_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's function in plain torch ops, with its two roundings:
    fp32 subtract, fp32 multiply, then the cast."""
    c = mean.numel()
    x = u8.reshape(-1, c).float()
    return ((x - mean) * inv_std).to(out_dtype).reshape(u8.shape)


def make_preprocess_fn(image_shape: Tuple[int, int, int],
                       mean: Sequence[float] = (127.5, 127.5, 127.5),
                       std: Sequence[float] = (127.5, 127.5, 127.5),
                       out_dtype=torch.bfloat16):
    """``fn(u8 (B, H*W*C) or (B, H, W, C)) -> (B, H, W, C)`` normalized
    ``out_dtype`` activations, through K1 on a card. Call it inside the
    loss, ahead of the first layer: only uint8 crosses to the device.
    Input of another dtype is cast to uint8 first, as the reference does.
    No gradient flows into the input, so K1 needs no backward."""
    h, w, c = (int(v) for v in image_shape)
    mean_h = np.asarray(mean, np.float32).ravel()
    istd_h = _inv_std(std).ravel()
    if mean_h.size != c or istd_h.size != c:
        raise ValueError(f"mean/std of length {mean_h.size}/{istd_h.size} "
                         f"for {c} channels")
    consts = {}

    def preprocess(u8: torch.Tensor) -> torch.Tensor:
        if u8.dtype != torch.uint8:
            u8 = u8.to(torch.uint8)
        if u8.device not in consts:
            consts[u8.device] = tuple(torch.from_numpy(a).to(u8.device)
                                      for a in (mean_h, istd_h))
        out = fused_normalize(u8.contiguous(), *consts[u8.device], out_dtype)
        return out.reshape(u8.shape[0], h, w, c)
    return preprocess


def _taps(src: int, dst: int, crop_off: float = 0.0,
          crop_size: Optional[int] = None
          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per output index: the two source indices and the weight of the
    second, by the reference's ``_sampling_matrix`` formula."""
    size = src if crop_size is None else crop_size
    s = crop_off + (np.arange(dst) + 0.5) * size / dst - 0.5
    i0 = np.clip(np.floor(s).astype(np.int64), 0, src - 1)
    i1 = np.clip(i0 + 1, 0, src - 1)
    frac = np.clip(s - i0, 0.0, 1.0).astype(np.float32)
    return i0, i1, frac


def _sampling_matrix(src: int, dst: int, crop_off: float = 0.0,
                     crop_size: Optional[int] = None) -> np.ndarray:
    """(dst, src) bilinear sampling matrix, bit-equal to the reference's
    ``mmlspark_tpu.ops.pallas_preprocess._sampling_matrix``. The port
    computes with the taps; the matrix is the documented contract."""
    i0, i1, frac = _taps(src, dst, crop_off, crop_size)
    m = np.zeros((dst, src), np.float32)
    m[np.arange(dst), i0] += 1.0 - frac
    m[np.arange(dst), i1] += frac
    return m


# K2's shared memory for one block's staged source rows and x-tap tables:
# within the 48 KB a block gets without an opt-in, so several blocks share
# an SM and one block's copy-in overlaps another's compute
K2_SMEM_BUDGET = 48 * 1024
# output rows per K2 block, at most: 8 rows of 224x3 bf16 are 224 units of
# 8 pixels (three 16-byte vectors each) for 128 threads (4 or 16 rows ran
# no faster at 256x256 -> 224x224: preprocess_variants.py on an H100)
K2_BAND_ROWS = 8
# K2 indexes an image's bytes and outputs in 32 bits
_INT32_MAX = 2 ** 31 - 1


class CropResizePlan:
    """The per-shape constants of one crop + resize + normalize: taps per
    axis, per-channel mean and 1/std, and K2's bands, as host arrays and,
    per device, as the small tensors the kernel and the plain version read.

    K2 runs one block per (image, band of ``band_rows`` output rows). When
    ``staged`` is True each band's distinct source rows (``stage_rows[band,
    :stage_n[band]]``, sorted; ``slots[y]`` gives where y's two taps sit
    among them) and the x-tap tables fit ``smem_budget`` bytes, and the
    kernel copies them to shared memory first; ``band_rows`` is then the
    largest height up to ``K2_BAND_ROWS`` that fits. Otherwise (a source
    row of ``Ws * C`` bytes that is no multiple of 16, or two rows over the
    budget) the plan takes the direct-load variant, which reads the source
    through the cache."""

    def __init__(self, src_shape: Tuple[int, int, int],
                 resize: Optional[Tuple[int, int]] = None,
                 crop: Optional[Tuple[int, int]] = None,
                 mean: Sequence[float] = (0.0,),
                 std: Sequence[float] = (1.0,),
                 smem_budget: int = K2_SMEM_BUDGET):
        hs, ws, c = (int(v) for v in src_shape)
        ch, cw = (int(v) for v in crop) if crop else (hs, ws)
        if ch > hs or cw > ws:
            raise ValueError(f"crop {crop} exceeds source {src_shape}")
        hd, wd = (int(v) for v in resize) if resize else (ch, cw)
        self.src_shape = (hs, ws, c)
        self.dst_hw = (hd, wd)
        # integer floor offsets, matching ops.center_crop's slicing — a
        # fractional offset would blend adjacent pixels instead of cropping
        self.y = _taps(hs, hd, float((hs - ch) // 2), ch)
        self.x = _taps(ws, wd, float((ws - cw) // 2), cw)
        self.mean = np.broadcast_to(np.asarray(mean, np.float32), (c,)).copy()
        self.istd = (1.0 / np.broadcast_to(np.asarray(std, np.float32), (c,))
                     ).astype(np.float32)
        self._plan_bands(smem_budget)
        self._on = {}

    def _bands(self, rows: int):
        """Each band's sorted distinct source rows, for bands of ``rows``."""
        y0, y1, _ = self.y
        return [np.union1d(y0[a:a + rows], y1[a:a + rows])
                for a in range(0, self.dst_hw[0], rows)]

    def smem_bytes(self, stage_max: int) -> int:
        """Shared memory of a staged K2 block: ``stage_max`` source rows,
        the x-taps (x0 * C, x1 * C, fx) and mean / 1/std."""
        hs, ws, c = self.src_shape
        return stage_max * ws * c + 12 * self.dst_hw[1] + 8 * c

    def _plan_bands(self, budget: int) -> None:
        hd = self.dst_hw[0]
        self.staged = False
        self.band_rows = max(1, min(K2_BAND_ROWS, hd))
        bands = self._bands(self.band_rows)
        if self.src_shape[1] * self.src_shape[2] % 16 == 0:
            for rows in range(self.band_rows, 0, -1):
                found = self._bands(rows)
                if self.smem_bytes(max(b.size for b in found)) <= budget:
                    self.staged, self.band_rows, bands = True, rows, found
                    break
        self.stage_max = max(b.size for b in bands)
        self.stage_n = np.array([b.size for b in bands], np.int32)
        self.stage_rows = np.stack([np.pad(b, (0, self.stage_max - b.size),
                                           mode="edge") for b in bands]
                                   ).astype(np.int32)
        y0, y1, _ = self.y
        band = np.arange(hd) // self.band_rows
        self.slots = np.stack(
            [np.array([np.searchsorted(bands[b], t[y]) for y, b in
                       enumerate(band)]) for t in (y0, y1)], axis=1
        ).astype(np.int32)

    def variant(self, data_ptr: int) -> str:
        """The K2 variant for a source at ``data_ptr``: "staged" when the
        plan stages and the source starts on 16 bytes, else "direct"."""
        return "staged" if self.staged and data_ptr % 16 == 0 else "direct"

    def on(self, device) -> Tuple[torch.Tensor, ...]:
        """(y0, y1, fy, x0, x1, fx, mean, istd, slots, stage_rows, stage_n)
        on ``device``; indices int32, weights float32. The plain version
        reads the first eight."""
        device = torch.device(device)
        if device not in self._on:
            (y0, y1, fy), (x0, x1, fx) = self.y, self.x
            host = [y0.astype(np.int32), y1.astype(np.int32), fy,
                    x0.astype(np.int32), x1.astype(np.int32), fx,
                    self.mean, self.istd, self.slots, self.stage_rows,
                    self.stage_n]
            self._on[device] = tuple(torch.from_numpy(np.ascontiguousarray(a))
                                     .to(device) for a in host)
        return self._on[device]

    def bytes_moved(self, batch: int, out_dtype=torch.float32) -> int:
        """Least bytes one call on ``batch`` images must move: the source
        rows and columns that carry weight, read once, and the output,
        written once."""
        def used(i0, i1, frac):
            return np.union1d(i0[frac < 1], i1[frac > 0]).size
        rows, cols = used(*self.y), used(*self.x)
        c = self.src_shape[2]
        hd, wd = self.dst_hw
        out_size = torch.empty((), dtype=out_dtype).element_size()
        return batch * (rows * cols * c + hd * wd * c * out_size)


def crop_resize_normalize(u8: torch.Tensor, plan: CropResizePlan,
                          out_dtype=torch.float32) -> torch.Tensor:
    """K2: uint8 (B, Hs, Ws, C) -> (B, Hd, Wd, C) ``out_dtype``.

    A CUDA tensor launches the hand-written kernel; a CPU tensor takes the
    plain version. Anything the kernel does not take raises."""
    if u8.device.type == "cpu":
        return _crop_resize_normalize_plain(u8, plan, out_dtype)
    if u8.device.type != "cuda":
        raise ValueError(f"crop_resize_normalize: no kernel for device "
                         f"{u8.device}")
    if u8.dtype != torch.uint8:
        raise TypeError(f"crop_resize_normalize wants uint8, got {u8.dtype}")
    if tuple(u8.shape[1:]) != plan.src_shape:
        raise ValueError(f"crop_resize_normalize: images {tuple(u8.shape)} "
                         f"do not match the plan's source {plan.src_shape}")
    if not u8.is_contiguous():
        raise ValueError("crop_resize_normalize wants a contiguous batch")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"crop_resize_normalize: out_dtype {out_dtype} is "
                        "neither float32 nor bfloat16")
    b, hs, ws, c = u8.shape
    hd, wd = plan.dst_hw
    bands = -(-hd // plan.band_rows)
    if max(hs * ws * c, hd * wd * c, b * bands) > _INT32_MAX:
        raise ValueError(f"crop_resize_normalize: images {tuple(u8.shape)} "
                         f"-> {plan.dst_hw} overflow the kernel's 32-bit "
                         "offsets; split the batch or the images")
    consts = plan.on(u8.device)
    variant = plan.variant(u8.data_ptr())
    out = torch.empty((b, hd, wd, c), dtype=out_dtype, device=u8.device)
    with torch.cuda.device(u8.device):
        stream = torch.cuda.current_stream(u8.device).cuda_stream
        CROP_RESIZE_NORMALIZE(
            u8.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in consts),
            b, hs, ws, hd, wd, c, plan.band_rows, plan.stage_max,
            int(variant == "staged"), int(out_dtype == torch.bfloat16),
            stream, variant=variant)
    return out


def _crop_resize_normalize_plain(u8: torch.Tensor, plan: CropResizePlan,
                                 out_dtype=torch.float32) -> torch.Tensor:
    """The kernel's function in plain torch ops, with the kernel's
    operation order: row lerp, then column lerp, in fp32."""
    y0, y1, fy, x0, x1, fx, mean, istd = plan.on(u8.device)[:8]
    x = u8.float()
    wy = fy[None, :, None, None]
    rows = x.index_select(1, y0) * (1 - wy) + x.index_select(1, y1) * wy
    wx = fx[None, None, :, None]
    z = rows.index_select(2, x0) * (1 - wx) + rows.index_select(2, x1) * wx
    z = z.round().clamp(0.0, 255.0)
    return ((z - mean) * istd).to(out_dtype)


def make_fused_preprocess_fn(src_shape: Tuple[int, int, int],
                             resize: Optional[Tuple[int, int]] = None,
                             crop: Optional[Tuple[int, int]] = None,
                             mean: Sequence[float] = (0.0,),
                             std: Sequence[float] = (1.0,),
                             out_dtype=torch.float32):
    """The whole image preprocess as ONE kernel launch: uint8 in,
    center-crop + bilinear-resize + normalize, model-ready activations out —
    the OpenCV pipeline the reference ran per-row on CPUs
    (``ImageTransformer.scala:33-153``), run ahead of the first layer.

    ``fn(u8 (B, Hs*Ws*C) or (B, Hs, Ws, C)) -> (B, Hd, Wd, C)``.
    ``crop`` is a center-crop (h, w) applied BEFORE ``resize`` (either may
    be None); per-channel ``mean``/``std`` normalize after the host-parity
    requantize. ``out_dtype`` is float32 or bfloat16."""
    plan = CropResizePlan(src_shape, resize, crop, mean, std)
    hs, ws, c = plan.src_shape

    def preprocess(u8: torch.Tensor) -> torch.Tensor:
        if u8.dtype != torch.uint8:
            u8 = u8.to(torch.uint8)
        u8 = u8.reshape(u8.shape[0], hs, ws, c).contiguous()
        return crop_resize_normalize(u8, plan, out_dtype)
    return preprocess


def device_resize_bilinear(x: torch.Tensor, height: int,
                           width: int) -> torch.Tensor:
    """Bilinear resize of (B, H, W, C) float images on their device,
    half-pixel centers with edge clamp — the SAME convention as the host
    path (``image/ops.py _resize_stack``), so resizing on the device is a
    pure acceleration, not a semantic change. (``F.interpolate`` with
    ``antialias=True`` would diverge on downscale.) Two gathered-row blends
    per axis, in plain torch."""
    h, w = x.shape[1:3]
    if (h, w) == (height, width):
        return x
    y0, y1, wy, x0, x1, wx = (torch.from_numpy(a).to(x.device)
                              for a in _taps(h, height) + _taps(w, width))
    wy = wy[None, :, None, None]
    wx = wx[None, None, :, None]
    rows = x.index_select(1, y0) * (1 - wy) + x.index_select(1, y1) * wy
    return rows.index_select(2, x0) * (1 - wx) \
        + rows.index_select(2, x1) * wx
