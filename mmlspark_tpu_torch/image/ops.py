"""Per-image ops backing the ImageTransformer stages, in vectorized numpy.

The PyTorch port's own copy of ``mmlspark_tpu/image/ops.py``. Counterparts of the reference's OpenCV stage set
(``image-transformer/src/main/scala/ImageTransformer.scala:23-154``):
resize / crop / colorformat / blur / threshold / gaussiankernel, plus flip
and normalize. Host-side numpy handles ragged pre-resize sizes; once images
are uniform, the batched fused path (``mmlspark_tpu_torch.ops.preprocess``)
takes over on device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# colorformat codes (subset of OpenCV's, same names)
BGR2GRAY = "bgr2gray"
GRAY2BGR = "gray2bgr"
BGR2RGB = "bgr2rgb"
RGB2BGR = "rgb2bgr"

THRESH_BINARY = "binary"
THRESH_BINARY_INV = "binary_inv"
THRESH_TRUNC = "trunc"
THRESH_TOZERO = "tozero"
THRESH_TOZERO_INV = "tozero_inv"


def _resize_stack(stack: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bilinear resize of a uniform (N, H, W, C) stack, half-pixel centers
    (OpenCV INTER_LINEAR convention). One vectorized gather/lerp for the
    whole stack — the per-image loop is the hot-path sin."""
    n, h, w = stack.shape[:3]
    ys = (np.arange(height) + 0.5) * h / height - 0.5
    xs = (np.arange(width) + 0.5) * w / width - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[None, :, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, None, :, None]
    f = stack.astype(np.float32)
    r0, r1 = f[:, y0], f[:, y1]
    top = r0[:, :, x0] * (1 - wx) + r0[:, :, x1] * wx
    bot = r1[:, :, x0] * (1 - wx) + r1[:, :, x1] * wx
    out = top * (1 - wy) + bot * wy
    if stack.dtype == np.uint8:
        out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out


def resize(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bilinear resize, half-pixel centers (OpenCV INTER_LINEAR convention)."""
    h, w = img.shape[:2]
    if (h, w) == (height, width):
        return img
    squeeze = img.ndim == 2
    out = _resize_stack(img[None, :, :, None] if squeeze else img[None],
                        height, width)[0]
    return out[:, :, 0] if squeeze else out


def resize_many(imgs, height: int, width: int):
    """Resize a ragged list of images, batching every same-(shape, dtype)
    group through ONE vectorized ``_resize_stack`` call. Order preserved."""
    out = [None] * len(imgs)
    groups: dict = {}
    for i, im in enumerate(imgs):
        if im.shape[:2] == (height, width):
            out[i] = im
        else:
            groups.setdefault((im.shape, str(im.dtype)), []).append(i)
    for (shape, _), idxs in groups.items():
        stack = np.stack([imgs[i] for i in idxs])
        squeeze = len(shape) == 2
        res = _resize_stack(stack[..., None] if squeeze else stack,
                            height, width)
        for j, i in enumerate(idxs):
            out[i] = res[j, :, :, 0] if squeeze else res[j]
    return out


def crop(img: np.ndarray, x: int, y: int, height: int, width: int) -> np.ndarray:
    h, w = img.shape[:2]
    if y < 0 or x < 0 or y + height > h or x + width > w:
        raise ValueError(f"crop ({x},{y},{width}x{height}) outside {w}x{h}")
    return img[y:y + height, x:x + width]


def center_crop(img: np.ndarray, height: int, width: int) -> np.ndarray:
    h, w = img.shape[:2]
    return crop(img, (w - width) // 2, (h - height) // 2, height, width)


def color_format(img: np.ndarray, fmt: str) -> np.ndarray:
    if fmt == BGR2GRAY:
        # OpenCV luma weights for BGR order
        gray = (img[..., 0] * 0.114 + img[..., 1] * 0.587
                + img[..., 2] * 0.299)
        out = np.rint(gray) if img.dtype == np.uint8 else gray
        return out.astype(img.dtype)[..., None]
    if fmt == GRAY2BGR:
        ch = img if img.ndim == 2 else img[..., 0]
        return np.repeat(ch[..., None], 3, axis=-1)
    if fmt in (BGR2RGB, RGB2BGR):
        return img[..., ::-1]
    raise ValueError(f"unknown color format {fmt!r}")


def blur(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Box blur with BORDER_REFLECT_101-ish edge handling via edge padding."""
    kh, kw = int(height), int(width)
    img_f = img.astype(np.float32)
    if img_f.ndim == 2:
        img_f = img_f[:, :, None]
    out = _separable_filter(img_f, np.full(kh, 1.0 / kh, np.float32),
                            np.full(kw, 1.0 / kw, np.float32))
    if img.dtype == np.uint8:
        out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out if img.ndim == 3 else out[:, :, 0]


def gaussian_kernel_1d(aperture: int, sigma: float) -> np.ndarray:
    """OpenCV getGaussianKernel: sigma<=0 -> 0.3*((ksize-1)*0.5 - 1) + 0.8."""
    if sigma <= 0:
        sigma = 0.3 * ((aperture - 1) * 0.5 - 1) + 0.8
    xs = np.arange(aperture, dtype=np.float64) - (aperture - 1) / 2
    k = np.exp(-(xs ** 2) / (2 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: np.ndarray, aperture: int, sigma: float) -> np.ndarray:
    """Reference GaussianKernel stage: filter2D with a 1-D vertical gaussian
    kernel (a COLUMN filter, not a full 2-D gaussian)."""
    k = gaussian_kernel_1d(aperture, sigma)
    img_f = img.astype(np.float32)
    if img_f.ndim == 2:
        img_f = img_f[:, :, None]
    out = _separable_filter(img_f, k, np.ones(1, np.float32))
    if img.dtype == np.uint8:
        out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out if img.ndim == 3 else out[:, :, 0]


def threshold(img: np.ndarray, thresh: float, max_val: float,
              ttype: str = THRESH_BINARY) -> np.ndarray:
    x = img.astype(np.float32)
    if ttype == THRESH_BINARY:
        out = np.where(x > thresh, max_val, 0.0)
    elif ttype == THRESH_BINARY_INV:
        out = np.where(x > thresh, 0.0, max_val)
    elif ttype == THRESH_TRUNC:
        out = np.minimum(x, thresh)
    elif ttype == THRESH_TOZERO:
        out = np.where(x > thresh, x, 0.0)
    elif ttype == THRESH_TOZERO_INV:
        out = np.where(x > thresh, 0.0, x)
    else:
        raise ValueError(f"unknown threshold type {ttype!r}")
    return out.astype(img.dtype) if img.dtype == np.uint8 else out


def flip(img: np.ndarray, horizontal: bool = True) -> np.ndarray:
    return img[:, ::-1] if horizontal else img[::-1]


def _separable_filter(img: np.ndarray, kcol: np.ndarray,
                      krow: np.ndarray) -> np.ndarray:
    """Apply column then row 1-D filters with edge padding (H, W, C)."""
    kh, kw = len(kcol), len(krow)
    ph, pw = kh // 2, kw // 2
    padded = np.pad(img, ((ph, kh - 1 - ph), (0, 0), (0, 0)), mode="edge")
    out = np.zeros_like(img)
    for i, kv in enumerate(kcol):
        out += kv * padded[i:i + img.shape[0]]
    if kw > 1:
        padded = np.pad(out, ((0, 0), (pw, kw - 1 - pw), (0, 0)), mode="edge")
        out2 = np.zeros_like(out)
        for i, kv in enumerate(krow):
            out2 += kv * padded[:, i:i + img.shape[1]]
        out = out2
    return out
