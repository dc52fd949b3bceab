"""The compile seam of the serving programs, and its (bypassed) cache.

The port's copy of ``mmlspark_tpu/compile_cache.py``. There, the serve
bucket executables and the generate lane's programs are compiled through
:func:`load_or_compile` / :func:`load_or_compile_program`, which load a
verified serialized executable from ``runtime.compile_cache_dir`` when one
exists and compile, then store, otherwise. Here the programs are CUDA
graphs captured per padded shape (``serve/programs.py``; the eager
function on the CPU), built by a ``fresh()`` callable the caller passes
in. A CUDA graph cannot be serialized: its kernel nodes point at device
addresses of one process. So every program takes the reference's bypass
branch of ``_store_entry``: it is built afresh, a ``bypass`` is counted
and a ``compile_cache.bypass`` event says why, and nothing is written to
disk. With ``runtime.compile_cache_dir`` set there is never an entry to
load, so that case also counts a ``miss``.

The keys (:func:`entry_key`, :func:`program_key`) are the reference's pure
hashing, unchanged, and :func:`stats` has its counters.
"""
from __future__ import annotations

import hashlib
import os
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np

from mmlspark_tpu_torch.observability import events, metrics
from mmlspark_tpu_torch.utils import config as mmlconfig
from mmlspark_tpu_torch.utils.logging import get_logger

logger = get_logger("compile_cache")

_NOT_SERIALIZABLE = ("CUDA graphs (and the CPU's eager programs) are not "
                     "serializable: built afresh, nothing stored")


class CacheResult(NamedTuple):
    """What the seam did: the program plus its provenance (``source`` in
    {hit, miss, stale, corrupt, bypass}); the port only ever builds, so it
    is ``miss`` or ``bypass``."""
    program: Callable
    source: str

    @property
    def hit(self) -> bool:
        return self.source == "hit"


def cache_dir() -> str:
    """The configured cache root ("" = caching off)."""
    return str(mmlconfig.get("runtime.compile_cache_dir") or "")


def worker_env(root: Optional[str] = None) -> Dict[str, str]:
    """Environment exports that point a child process at the same cache
    root; ``{}`` when caching is off."""
    root = cache_dir() if root is None else str(root or "")
    if not root:
        return {}
    return {"MMLSPARK_TPU_TORCH_RUNTIME_COMPILE_CACHE_DIR":
            os.path.abspath(root)}


def enable_from_config() -> Optional[str]:
    """The cache root when ``runtime.compile_cache_dir`` is set, else None.
    The reference wires jax's persistent compilation cache here; the port
    has no compiled program to persist (eager torch, CUDA graphs, and the
    hand-written kernels' own nvcc cache under ``kernels/_build``), so it
    only records the setting."""
    root = cache_dir()
    if not root:
        return None
    if events.recording_enabled():
        events.emit("compile_cache", "enabled", dir=root,
                    note=_NOT_SERIALIZABLE)
    return root


def device_fingerprint() -> str:
    """Identity of the toolchain and the device a program is built for:
    the torch and CUDA versions, the card's name and its ``sm_XX``."""
    import torch
    parts = [f"torch={torch.__version__}", f"cuda={torch.version.cuda}"]
    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability(0)
        parts += [f"device={torch.cuda.get_device_name(0)}",
                  f"sm=sm_{major}{minor}",
                  f"n={torch.cuda.device_count()}"]
    else:
        parts.append("device=cpu")
    return "|".join(parts)


def entry_key(model: str, version: str, bucket: int,
              row_shape: Tuple[int, ...], dtype: str,
              mesh_key: str = "") -> str:
    """Filename stem of one scoring program: the model and padded shape
    identity (the reference's hashing, unchanged)."""
    parts = [model, version, str(int(bucket)),
             ",".join(str(int(d)) for d in row_shape), str(dtype)]
    if mesh_key:
        parts.append(f"mesh={mesh_key}")
    ident = "\x00".join(parts)
    return hashlib.sha256(ident.encode("utf-8")).hexdigest()[:40]


def program_key(model: str, version: str, kind: str, shape_key: str) -> str:
    """Filename stem of one generate-lane program: (model+version, program
    kind, the caller's shape string), the reference's hashing."""
    ident = "\x00".join([model, version, kind, shape_key])
    return hashlib.sha256(ident.encode("utf-8")).hexdigest()[:40]


def _counter(name: str):
    return metrics.counter(f"compile_cache.{name}")


def _event(name: str, **fields: Any) -> None:
    if events.recording_enabled():
        events.emit("compile_cache", name, **fields)


def _built(stem: str, meta: Dict[str, Any],
           fresh: Callable[[], Callable]) -> CacheResult:
    """The reference's load -> compile -> store body with the store always
    bypassed: build with ``fresh()``, count and event the bypass."""
    root = cache_dir()
    if not root:
        program = fresh()
        _counter("bypasses").inc()
        _event("bypass", reason="runtime.compile_cache_dir unset", **meta)
        return CacheResult(program, "bypass")
    _counter("misses").inc()
    _event("miss", key=stem, env=device_fingerprint(), **meta)
    program = fresh()
    _counter("bypasses").inc()
    _event("bypass", reason=f"store: {_NOT_SERIALIZABLE}", **meta)
    return CacheResult(program, "miss")


def load_or_compile(model: str, version: str, bucket: int,
                    row_shape: Tuple[int, ...], dtype: Any,
                    fresh: Callable[[], Callable],
                    mesh_key: str = "") -> CacheResult:
    """The scoring seam: the program of one padded bucket shape, built by
    ``fresh()`` (the registry's capture)."""
    dtype_name = np.dtype(dtype).name
    meta = {"model": model, "version": version, "bucket": int(bucket),
            "row_shape": [int(d) for d in row_shape], "dtype": dtype_name}
    if mesh_key:
        meta["mesh"] = mesh_key
    return _built(entry_key(model, version, bucket, tuple(row_shape),
                            dtype_name, mesh_key), meta, fresh)


def load_or_compile_program(model: str, version: str, kind: str,
                            shape_key: str,
                            fresh: Callable[[], Callable]) -> CacheResult:
    """The generate lane's seam: one (kind, bucket) program, built by
    ``fresh()``."""
    meta = {"model": model, "version": version, "kind": kind,
            "shape_key": shape_key}
    return _built(program_key(model, version, kind, shape_key), meta, fresh)


def stats() -> Dict[str, int]:
    """Hit/miss/bypass/stale/quarantine/store counter snapshot."""
    return {name: int(_counter(name).value)
            for name in ("hits", "misses", "bypasses", "stale",
                         "quarantined", "stores")}
