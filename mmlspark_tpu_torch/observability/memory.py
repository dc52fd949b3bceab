"""Device-memory ledger: one accounting home for device bytes.

The port's copy of ``mmlspark_tpu/observability/memory.py``, single-device
part. The serving registry, the KV arena and the program cache report here
instead of summing bytes each on its own:

- :func:`nbytes_of` / :func:`param_bytes` — the size arithmetic the
  registry and the KV arena delegate to, over the port's flat state dicts
  (name -> tensor or numpy array);
- :class:`MemoryLedger` — bytes by ``{model, kind in
  params|table|kv|program}`` (``table`` = embedding rows, split out by
  :func:`split_param_shard_bytes`) with a process high-watermark,
  published as ``memory.*`` gauges;
- ``memory.pressure`` events when the registry's LRU evicts a warm model;
- :func:`audit_device_bytes` — ``torch.cuda.memory_allocated`` against the
  ledger, flagging the unaccounted remainder; :func:`start_audit_poller`
  runs it every ``observability.memory_poll_s`` seconds (0 = off).

A parameter a meshed trainer placed carries its ``_mesh_sharding``
(``parallel/sharding.py``): it holds its rank's shard, whose bytes are
what :func:`shard_bytes_of` charges, while :func:`param_bytes` counts the
whole (unsharded) parameter. On one device a shard is the whole tensor,
so the ``*shard*`` functions equal their unsharded twins.
:func:`projected_shard_bytes` sizes a host state dict's shards on a mesh
under the sharding rules before anything is placed.
"""
from __future__ import annotations

import re
import threading
from collections.abc import Mapping
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from mmlspark_tpu_torch.observability import events, metrics
from mmlspark_tpu_torch.utils import config as mmlconfig

KINDS = ("params", "table", "kv", "program")

# embedding-table entries: a state-dict name ending in "embedding"
# ("token_embedding.embedding", "pos_embedding") is table rows, everything
# else dense weights, as the reference keys its flax paths
_TABLE_LEAF = re.compile(r".*embedding$")


def _itemsize(dtype: Any) -> int:
    import torch
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def nbytes_of(shape: Sequence[int], dtype: Any) -> int:
    """Bytes of one dense array of ``shape`` and ``dtype`` (a torch or a
    numpy dtype)."""
    n = 1
    for d in shape:
        n *= int(d)
    return n * _itemsize(dtype)


def _leaves(params: Any):
    if isinstance(params, Mapping):
        return list(params.items())
    return [(str(i), leaf) for i, leaf in enumerate(params)]


def _whole_shape(leaf: Any) -> Sequence[int]:
    sh = getattr(leaf, "_mesh_sharding", None)
    return sh.shape if sh is not None else leaf.shape


def param_bytes(params: Any) -> int:
    """Summed bytes of every tensor or array in a flat state dict, a
    module's parameters or a sequence of them, each counted whole (a
    meshed shard as the parameter it is part of); 0 for None."""
    if params is None:
        return 0
    if hasattr(params, "named_parameters"):
        params = dict(params.named_parameters())
    return sum(nbytes_of(_whole_shape(leaf), leaf.dtype)
               for _, leaf in _leaves(params)
               if hasattr(leaf, "shape") and hasattr(leaf, "dtype"))


def shard_bytes_of(leaf: Any) -> int:
    """Bytes of one tensor as resident on one device: its shard on a mesh
    (a placed parameter holds just that), else the whole tensor."""
    if not (hasattr(leaf, "shape") and hasattr(leaf, "dtype")):
        return 0
    return nbytes_of(leaf.shape, leaf.dtype)


def param_shard_bytes(params: Any) -> int:
    """Per-device resident bytes of a state dict (or a module's
    parameters): the sum of :func:`shard_bytes_of`."""
    if params is None:
        return 0
    if hasattr(params, "named_parameters"):
        params = dict(params.named_parameters())
    return sum(shard_bytes_of(leaf) for _, leaf in _leaves(params))


def projected_shard_bytes(params: Any, mesh: Any = None,
                          rules: Any = None) -> int:
    """Per-device bytes a host state dict (or module) would pin once
    placed: with a mesh, each leaf's shard under
    ``parallel.sharding.param_shardings(params, mesh, rules)`` (``mesh``
    a DeviceMesh or an ``{axis: size}`` dict); without one, the whole."""
    if mesh is None:
        return param_bytes(params)
    from mmlspark_tpu_torch.parallel.sharding import param_shardings
    if hasattr(params, "named_parameters"):
        params = dict(params.named_parameters())
    total = 0
    for name, sh in param_shardings(params, mesh, rules).items():
        total += nbytes_of(sh.shard_shape(), params[name].dtype)
    return total


def split_param_shard_bytes(params: Any) -> Tuple[int, int]:
    """``(dense_bytes, table_bytes)`` of a state dict: names matching
    ``.*embedding$`` are embedding rows (ledger kind ``table``), the rest
    dense weights (``params``). The two sum to :func:`param_shard_bytes`."""
    if params is None:
        return 0, 0
    dense = table = 0
    for name, leaf in _leaves(params):
        b = shard_bytes_of(leaf)
        if _TABLE_LEAF.match(str(name)):
            table += b
        else:
            dense += b
    return dense, table


class MemoryLedger:
    """Process-wide bytes-by-``{model, kind}`` map with a high-watermark.

    ``params``, ``table`` and ``kv`` are *set* (the registry re-syncs them
    after every warm and evict, so the ledger mirrors the warm set);
    ``program`` entries are keyed by the program's identity so charging
    the same program twice never double-counts.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._bytes: Dict[Tuple[str, str], int] = {}
        self._programs: Dict[str, Dict[str, int]] = {}
        self._hwm = 0

    # -- writes ------------------------------------------------------------
    def set_bytes(self, model: str, kind: str, nbytes: int) -> None:
        if kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
        with self._lock:
            if nbytes <= 0:
                self._bytes.pop((str(model), kind), None)
            else:
                self._bytes[(str(model), kind)] = int(nbytes)
        self._publish()

    def note_program(self, model: str, key: str, nbytes: int) -> None:
        """Charge one program (idempotent per ``key``)."""
        with self._lock:
            progs = self._programs.setdefault(str(model), {})
            progs[str(key)] = int(nbytes)
            self._bytes[(str(model), "program")] = sum(progs.values())
        self._publish()

    def clear(self, model: Optional[str] = None,
              kind: Optional[str] = None) -> None:
        with self._lock:
            if model is None and kind is None:
                self._bytes.clear()
                self._programs.clear()
            else:
                for k in list(self._bytes):
                    if ((model is None or k[0] == str(model))
                            and (kind is None or k[1] == kind)):
                        del self._bytes[k]
                if kind in (None, "program"):
                    if model is None:
                        self._programs.clear()
                    else:
                        self._programs.pop(str(model), None)
        self._publish()

    def reset(self) -> None:
        with self._lock:
            self._bytes.clear()
            self._programs.clear()
            self._hwm = 0
        self._publish()

    # -- reads -------------------------------------------------------------
    def total(self, model: Optional[str] = None,
              kind: Optional[str] = None) -> int:
        with self._lock:
            return sum(v for k, v in self._bytes.items()
                       if (model is None or k[0] == str(model))
                       and (kind is None or k[1] == kind))

    @property
    def high_watermark(self) -> int:
        return self._hwm

    def snapshot(self) -> Dict[str, Any]:
        """``{total_bytes, high_watermark_bytes, by_kind, by_model}``."""
        with self._lock:
            by_model: Dict[str, Dict[str, int]] = {}
            by_kind = {k: 0 for k in KINDS}
            for (model, kind), v in sorted(self._bytes.items()):
                by_model.setdefault(model, {})[kind] = v
                by_kind[kind] += v
            return {"total_bytes": sum(self._bytes.values()),
                    "high_watermark_bytes": self._hwm,
                    "by_kind": by_kind,
                    "by_model": by_model}

    # -- eviction pressure -------------------------------------------------
    def on_eviction(self, model: str, freed_bytes: int, *,
                    resident_bytes: int, budget_bytes: float,
                    reason: str = "lru") -> None:
        """The registry's LRU evicted a warm model: clear its lines and
        emit a ``memory.pressure`` event plus a counter."""
        self.clear(model)
        metrics.counter("memory.pressure").inc()
        if events.recording_enabled():
            events.emit("memory", "pressure", model=str(model),
                        reason=reason, freed_bytes=int(freed_bytes),
                        resident_bytes=int(resident_bytes),
                        budget_bytes=float(budget_bytes))

    # -- internal ----------------------------------------------------------
    def _publish(self) -> None:
        with self._lock:
            by_kind = {k: 0 for k in KINDS}
            for (_, kind), v in self._bytes.items():
                by_kind[kind] += v
            total = sum(self._bytes.values())
            if total > self._hwm:
                self._hwm = total
            hwm = self._hwm
        metrics.gauge("memory.hbm_bytes").set(total)
        metrics.gauge("memory.hbm_high_watermark_bytes").set(hwm)
        for kind, v in by_kind.items():
            metrics.gauge(f"memory.bytes.{kind}").set(v)


_LEDGER = MemoryLedger()


def get_ledger() -> MemoryLedger:
    """The process-wide ledger every accounting site reports into."""
    return _LEDGER


def audit_device_bytes(ledger: Optional[MemoryLedger] = None,
                       device: Any = None) -> Dict[str, Any]:
    """Compare the bytes the caching allocator holds in live tensors on
    ``device`` (``torch.cuda.memory_allocated``; the current CUDA device
    when None) with the ledger. ``unaccounted_bytes`` > 0 is device memory
    the ledger does not know about (intermediates, graph pools, caches);
    advisory, as live and committed bytes can legitimately differ. On a
    machine without CUDA the result says ``supported: False``."""
    import torch
    ledger = ledger or get_ledger()
    accounted = ledger.total()
    if not torch.cuda.is_available():
        return {"supported": False, "error": "no CUDA device",
                "accounted_bytes": accounted}
    live = int(torch.cuda.memory_allocated(device))
    unaccounted = max(0, live - accounted)
    out = {"supported": True, "live_bytes": live,
           "accounted_bytes": accounted, "unaccounted_bytes": unaccounted}
    metrics.gauge("memory.unaccounted_bytes").set(unaccounted)
    if events.recording_enabled():
        events.emit("memory", "audit", **out)
    return out


_POLLER: Dict[str, Any] = {"thread": None, "stop": None}


def start_audit_poller(interval_s: Optional[float] = None) -> bool:
    """Run :func:`audit_device_bytes` on a daemon thread every
    ``observability.memory_poll_s`` seconds (<= 0 = disabled, no thread).
    Idempotent; returns True when a poller is running."""
    interval = float(interval_s if interval_s is not None
                     else mmlconfig.get("observability.memory_poll_s"))
    if _POLLER["thread"] is not None:
        return True
    if interval <= 0:
        return False
    stop = threading.Event()

    def loop() -> None:
        while not stop.wait(interval):
            audit_device_bytes()

    t = threading.Thread(target=loop, name="mmlspark-tpu-torch-memaudit",
                         daemon=True)
    _POLLER["thread"], _POLLER["stop"] = t, stop
    t.start()
    return True


def stop_audit_poller() -> None:
    t, stop = _POLLER["thread"], _POLLER["stop"]
    if t is None:
        return
    stop.set()
    t.join(timeout=5.0)
    _POLLER["thread"] = _POLLER["stop"] = None
