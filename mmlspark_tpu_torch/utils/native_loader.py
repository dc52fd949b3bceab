"""NativeLoader: build-on-demand + ctypes loading of the C++ image codec.

The PyTorch port's copy of ``mmlspark_tpu/utils/native_loader.py``, a
re-expression of the reference's jar-resource native loader
(``core/env/src/main/scala/NativeLoader.java:29-193``): the checked-in
C++ source ``mmlspark_tpu_torch/native/imagecodec.cc`` is compiled once
per checkout by ``g++ -O2 -fPIC -shared ... -ljpeg -lpng -lpthread`` into
``mmlspark_tpu_torch/native/_build/`` (gitignored) and bound via ctypes.
It needs libjpeg's and libpng's headers and libraries; without them the
build fails, :func:`load_native` returns None, :func:`load_error` says
why, and the codecs fall back (PNG to the Python decoder, JPEG to None).
This is a host codec: nothing here touches a device.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")
_BUILD_DIR = os.path.join(_NATIVE_DIR, "_build")


def _lib_path() -> str:
    """Build target: ``native/_build/`` when the package is writable
    (cached per checkout), else a per-user 0700 temp dir (read-only
    installs). The temp dir must be OWNED by us and not group/world-
    writable before we will dlopen anything out of it — a predictable
    /tmp name that an attacker pre-created with a planted .so must not be
    trusted. Called lazily from load_native() so merely importing this
    module touches no filesystem."""
    if os.access(_NATIVE_DIR, os.W_OK):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        return os.path.join(_BUILD_DIR, "libmmlimage.so")
    import tempfile
    d = os.path.join(tempfile.gettempdir(),
                     f"mmlspark_tpu_torch_native_{os.getuid()}")
    try:
        os.makedirs(d, mode=0o700)
    except FileExistsError:
        st = os.lstat(d)
        if (st.st_uid != os.getuid() or not os.path.isdir(d)
                or os.path.islink(d) or (st.st_mode & 0o022)):
            d = tempfile.mkdtemp(prefix="mmlspark_tpu_torch_native_")
    return os.path.join(d, "libmmlimage.so")


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[str] = None


def _build(lib_path: str) -> None:
    """Compile into a private name, then rename: a process that loads
    concurrently sees the old library or the whole new one."""
    tmp = f"{lib_path}.tmp-{os.getpid()}"
    cmd = ["g++", "-O2", "-fPIC", "-shared",
           os.path.join(_NATIVE_DIR, "imagecodec.cc"),
           "-o", tmp, "-ljpeg", "-lpng", "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:           # no g++ on this machine
        raise RuntimeError(f"native build failed: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed:\n{proc.stderr[-2000:]}")
    os.replace(tmp, lib_path)


def load_native():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _load_error
    with _lock:
        if _lib is not None or _load_error is not None:
            return _lib
        try:
            lib_path = _lib_path()
            src = os.path.join(_NATIVE_DIR, "imagecodec.cc")
            built = False
            if (not os.path.exists(lib_path)
                    or os.path.getmtime(lib_path) < os.path.getmtime(src)):
                _build(lib_path)
                built = True
            try:
                lib = ctypes.CDLL(lib_path)
            except OSError:
                if built:
                    raise
                # a library built on another machine (a copied tree)
                # whose dependencies this one lacks: build it here
                _build(lib_path)
                lib = ctypes.CDLL(lib_path)
            lib.mml_decode_jpeg.restype = ctypes.c_int
            lib.mml_decode_jpeg.argtypes = [
                ctypes.c_char_p, ctypes.c_long,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            lib.mml_decode_png.restype = ctypes.c_int
            lib.mml_decode_png.argtypes = lib.mml_decode_jpeg.argtypes
            lib.mml_encode_jpeg.restype = ctypes.c_int
            lib.mml_encode_jpeg.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
                ctypes.POINTER(ctypes.c_ulong)]
            lib.mml_free.restype = None
            lib.mml_free.argtypes = [ctypes.c_void_p]
            lib.mml_decode_batch.restype = ctypes.c_int
            lib.mml_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_long), ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.c_int]
            _lib = lib
        except (RuntimeError, OSError) as e:
            _load_error = str(e)
            _lib = None
        return _lib


def native_available() -> bool:
    return load_native() is not None


def load_error() -> Optional[str]:
    """Why the native library is unavailable (the build's stderr tail or
    the load error), or None when it loaded or was not tried yet."""
    return _load_error


def _take_buffer(lib, out_ptr, w: int, h: int) -> np.ndarray:
    n = w * h * 3
    arr = np.ctypeslib.as_array(out_ptr, shape=(n,)).copy()
    lib.mml_free(out_ptr)
    return arr.reshape(h, w, 3)


def native_decode_jpeg(data: bytes) -> Optional[np.ndarray]:
    lib = load_native()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_ubyte)()
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.mml_decode_jpeg(data, len(data), ctypes.byref(out),
                             ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        return None
    return _take_buffer(lib, out, w.value, h.value)


def native_decode_png(data: bytes) -> Optional[np.ndarray]:
    lib = load_native()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_ubyte)()
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.mml_decode_png(data, len(data), ctypes.byref(out),
                            ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        return None
    return _take_buffer(lib, out, w.value, h.value)


def native_encode_jpeg(img: np.ndarray, quality: int = 90) -> Optional[bytes]:
    lib = load_native()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, _ = img.shape
    out = ctypes.POINTER(ctypes.c_ubyte)()
    size = ctypes.c_ulong()
    rc = lib.mml_encode_jpeg(img.tobytes(), w, h, quality,
                             ctypes.byref(out), ctypes.byref(size))
    if rc != 0:
        return None
    data = ctypes.string_at(out, size.value)
    lib.mml_free(out)
    return data


def native_decode_batch(blobs: List[bytes],
                        n_threads: int = 8) -> List[Optional[np.ndarray]]:
    """Threaded batch decode (JPEG/PNG); None entries for failures."""
    lib = load_native()
    if lib is None:
        return [None] * len(blobs)
    n = len(blobs)
    if n == 0:
        return []
    datas = (ctypes.c_char_p * n)(*blobs)
    sizes = (ctypes.c_long * n)(*[len(b) for b in blobs])
    outs = (ctypes.POINTER(ctypes.c_ubyte) * n)()
    widths = (ctypes.c_int * n)()
    heights = (ctypes.c_int * n)()
    lib.mml_decode_batch(datas, sizes, n, outs, widths, heights, n_threads)
    results: List[Optional[np.ndarray]] = []
    for i in range(n):
        if widths[i] == 0 or not outs[i]:
            results.append(None)
        else:
            results.append(_take_buffer(lib, outs[i], widths[i], heights[i]))
    return results
