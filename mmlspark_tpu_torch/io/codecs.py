"""Image codecs: decode bytes -> uint8 HWC BGR arrays.

The reference decodes via OpenCV's ``Imgcodecs.imdecode`` behind JNI
(``readers/src/main/scala/ImageReader.scala:25-40``). Here:

- BMP and PNG decode in pure numpy/zlib (always available, used by tests);
- JPEG (and PNG, first) decode through the native C++ bridge (libjpeg,
  libpng) when it builds (``mmlspark_tpu_torch/native``, built by g++ at
  first use by ``utils/native_loader.py``), mirroring the reference's
  native fast path;
- undecodable bytes return None and the caller drops the row, matching the
  reference's silent-drop semantics (``ImageReader.scala:55-59``) — but we
  count drops so callers CAN surface them.

Channel order is BGR row-major uint8, the reference ImageSchema convention
(``core/schema/src/main/scala/ImageSchema.scala:18-23``).

The PyTorch port's copy of ``mmlspark_tpu/io/codecs.py``: host code, the
same bytes in and the same arrays out. With no native library, PNG falls
back to the Python decoder and JPEG returns None, as in the reference.
"""
from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np


# -- BMP (24bpp uncompressed) ------------------------------------------------
def decode_bmp(data: bytes) -> Optional[np.ndarray]:
    try:
        if data[:2] != b"BM":
            return None
        pixel_off = struct.unpack_from("<I", data, 10)[0]
        header_size = struct.unpack_from("<I", data, 14)[0]
        if header_size < 40:
            return None
        w, h = struct.unpack_from("<ii", data, 18)
        planes, bpp = struct.unpack_from("<HH", data, 26)
        compression = struct.unpack_from("<I", data, 30)[0]
        if compression != 0 or bpp not in (24, 32):
            return None
        flip = h > 0
        h = abs(h)
        nch = bpp // 8
        row_size = (w * nch + 3) & ~3
        img = np.frombuffer(data, np.uint8, row_size * h, pixel_off)
        img = img.reshape(h, row_size)[:, :w * nch].reshape(h, w, nch)
        if flip:
            img = img[::-1]
        return np.ascontiguousarray(img[:, :, :3])  # already BGR in BMP
    except (struct.error, ValueError, IndexError):
        return None


def encode_bmp(img: np.ndarray) -> bytes:
    """uint8 HWC BGR -> 24bpp BMP (for tests/fixtures)."""
    h, w, c = img.shape
    assert c == 3
    row_size = (w * 3 + 3) & ~3
    pad = row_size - w * 3
    rows = b"".join(
        img[y].tobytes() + b"\x00" * pad for y in range(h - 1, -1, -1))
    pixel_off = 14 + 40
    size = pixel_off + len(rows)
    header = struct.pack("<2sIHHI", b"BM", size, 0, 0, pixel_off)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(rows),
                       2835, 2835, 0, 0)
    return header + info + rows


# -- PNG (8-bit gray/RGB/RGBA, non-interlaced) -------------------------------
_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def decode_png(data: bytes) -> Optional[np.ndarray]:
    try:
        if data[:8] != _PNG_SIG:
            return None
        pos, w = 8, None
        idat = b""
        while pos < len(data):
            length, ctype = struct.unpack_from(">I4s", data, pos)
            chunk = data[pos + 8:pos + 8 + length]
            if ctype == b"IHDR":
                w, h, depth, color, comp, filt, interlace = \
                    struct.unpack(">IIBBBBB", chunk)
                if depth != 8 or interlace != 0 or color not in (0, 2, 6):
                    return None
                nch = {0: 1, 2: 3, 6: 4}[color]
            elif ctype == b"IDAT":
                idat += chunk
            elif ctype == b"IEND":
                break
            pos += 12 + length
        if w is None:
            return None
        raw = zlib.decompress(idat)
        stride = w * nch
        out = np.empty((h, stride), np.uint8)
        prev = np.zeros(stride, np.uint16)
        off = 0
        for y in range(h):
            ftype = raw[off]
            row = np.frombuffer(raw, np.uint8, stride, off + 1).astype(np.uint16)
            off += 1 + stride
            if ftype == 0:
                cur = row
            elif ftype == 1:  # Sub
                cur = row.copy()
                for i in range(nch, stride):
                    cur[i] = (cur[i] + cur[i - nch]) & 0xFF
            elif ftype == 2:  # Up
                cur = (row + prev) & 0xFF
            elif ftype == 3:  # Average
                cur = row.copy()
                for i in range(stride):
                    left = cur[i - nch] if i >= nch else 0
                    cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
            elif ftype == 4:  # Paeth
                cur = row.copy()
                for i in range(stride):
                    a = int(cur[i - nch]) if i >= nch else 0
                    b = int(prev[i])
                    c = int(prev[i - nch]) if i >= nch else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                    cur[i] = (cur[i] + pred) & 0xFF
            else:
                return None
            out[y] = cur.astype(np.uint8)
            prev = cur
        img = out.reshape(h, w, nch)
        if nch == 1:
            img = np.repeat(img, 3, axis=2)
        elif nch == 4:
            img = img[:, :, :3]
        return np.ascontiguousarray(img[:, :, ::-1])  # RGB(A) -> BGR
    except (struct.error, ValueError, IndexError, zlib.error):
        return None


def encode_png(img: np.ndarray) -> bytes:
    """uint8 HWC BGR -> PNG RGB, filter 0 (for tests/fixtures)."""
    h, w, _ = img.shape
    rgb = img[:, :, ::-1]
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(ctype: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + ctype + payload
                + struct.pack(">I", zlib.crc32(ctype + payload)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_PNG_SIG + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


# -- dispatch ----------------------------------------------------------------
def decode_image(data: bytes) -> Optional[np.ndarray]:
    """bytes -> uint8 HWC BGR, or None if undecodable."""
    if not data or len(data) < 8:
        return None
    if data[:2] == b"BM":
        return decode_bmp(data)
    if data[:8] == _PNG_SIG:
        # native libpng first (the python Paeth/Sub loops are slow);
        # fall back to the pure-python decoder when the .so is absent
        try:
            from mmlspark_tpu_torch.utils.native_loader import (
                native_decode_png,
            )
            out = native_decode_png(data)
            if out is not None:
                return out
        except (ImportError, OSError, RuntimeError):
            pass  # no native build; the pure-python decoder below covers it
        return decode_png(data)
    if data[:3] == b"\xff\xd8\xff":  # JPEG via native bridge
        try:
            from mmlspark_tpu_torch.utils.native_loader import (
                native_decode_jpeg,
            )
            return native_decode_jpeg(data)
        except Exception:
            return None
    return None
