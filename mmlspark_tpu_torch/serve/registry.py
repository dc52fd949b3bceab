"""Multi-model serving registry: warm params on the device, one program per
bucket.

The port of ``mmlspark_tpu/serve/registry.py``. Each registered
:class:`~mmlspark_tpu_torch.models.torch_model.TorchModel` gets a
:class:`ModelEntry` that owns the serving-side programs:

- the model's module and bound apply on the server's device, built through
  the same ``TorchModel._device_apply`` memo ``transform`` uses, so serving
  and offline scoring share one placed module and one numerics path;
- one program per padded batch shape, made by the :meth:`ModelEntry._compile`
  hook — the seam the compile-discipline test wraps to count builds. On a
  CUDA device the program is a CUDA graph of the apply, captured over a
  static input buffer of shape ``(bucket,) + row_shape`` in the wire dtype,
  all of a model's graphs in one memory pool; on the CPU it is the eager
  apply at the padded bucket shape (``serve/programs.py``). Scoring a
  request never builds a program outside this hook.

Residency follows the ``runtime.device_cache_mb`` budget: the summed bytes
of warm entries (the module's parameters, plus a generate lane's KV arena)
must fit, and touching a model bumps it to most-recently-used while colder
entries are evicted (graphs, their pool and the placed module dropped). An
evicted model is NOT unregistered — the next request re-warms it, paying
its captures again.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.observability import memory as devmem
from mmlspark_tpu_torch.reliability.breaker import CircuitBreaker
from mmlspark_tpu_torch.serve import programs
from mmlspark_tpu_torch.utils import config as mmlconfig


class PlacementOverBudget(ValueError):
    """A ``replace`` target's bytes exceed the registry budget. Raised
    BEFORE the old entry is dropped, so the running version keeps
    serving."""


class ModelEntry:
    """One served model: coercion spec, placed module, per-bucket programs."""

    def __init__(self, name: str, model, version: str = "v1",
                 device: Optional[torch.device] = None):
        self.name = name
        self.model = model
        self.version = version
        self.device = (torch.device(device) if device is not None
                       else mmlconfig.resolve_device())
        self._spec = model._spec()
        self._apply = None
        self._module = None
        self._pool = None
        self._compiled: Dict[Tuple, Callable] = {}   # padded shape -> program
        self.compile_count = 0   # program builds (CUDA graph captures)
        self.cache_hits = 0      # programs loaded from a cache: always 0
        self.kv_arena_bytes = 0  # decode KV arena charged by the
                                 # generative lane (0 = no lane); counted
                                 # into resident_bytes so the LRU budget
                                 # sees params + arena as one tenant
        # per-model breaker: a model whose program keeps failing fails FAST
        # instead of burning executor time per batch; other models keep
        # serving
        self.breaker = CircuitBreaker(f"serve.{name}")

    # -- warm-up ----------------------------------------------------------
    def ensure_apply(self):
        """The model's bound apply on this entry's device, built lazily
        through the SAME memo as ``TorchModel.transform``: registering a
        model that was already used offline reuses its placed module (and
        vice versa)."""
        if self._apply is None:
            module, apply = self.model._device_apply(self.device)
            if getattr(apply, "meshed", False):
                apply.acquire()      # this entry's hold on the placement
            self._module, self._apply = module, apply
        return self._apply

    @property
    def mesh_key(self) -> str:
        """The placement's identity ("" off a mesh): program keys and the
        compile cache's keys carry it, so one name and version served on
        two placements never share a program."""
        return getattr(self.ensure_apply(), "mesh_key", "")

    @property
    def module(self) -> torch.nn.Module:
        self.ensure_apply()
        return self._module

    def graph_pool(self):
        """The memory pool every CUDA graph of this model captures into."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def coerce(self, arr) -> np.ndarray:
        """Host-side input coercion, identical to the offline scoring path
        (the same ``_coerce_batch``)."""
        return self.model._coerce_batch(np.asarray(arr), self._spec)

    # -- compile discipline ------------------------------------------------
    def _compile(self, bucket: int, row_shape: Tuple[int, ...],
                 dtype) -> Callable:
        """Build the program of one (bucket, row-shape, dtype) batch shape.
        THE compile seam: every serving-path build funnels through here
        exactly once per key — tests wrap this method to assert the
        at-most-one-build-per-bucket discipline. It goes through
        :func:`mmlspark_tpu_torch.compile_cache.load_or_compile`, which
        counts the build as a cache bypass (a CUDA graph is not
        serializable)."""
        from mmlspark_tpu_torch import compile_cache
        apply = self.ensure_apply()
        spec = ((int(bucket),) + tuple(int(d) for d in row_shape),
                torch.from_numpy(np.zeros((), np.dtype(dtype))).dtype)

        mesh_key = self.mesh_key

        def fresh():
            pool = self.graph_pool() if self.device.type == "cuda" \
                and not mesh_key else None
            return programs.build(
                apply, [spec], self.device, pool,
                key=f"{self.name}@{self.version}:{spec[0]}|mesh={mesh_key}")

        result = compile_cache.load_or_compile(
            self.name, self.version, bucket, tuple(row_shape), dtype, fresh,
            mesh_key=mesh_key)
        self.compile_count += 1
        return result.program

    @staticmethod
    def _program_key(bucket: int, row_shape: Tuple[int, ...],
                     dtype) -> Tuple:
        """Canonical program identity: the PADDED batch shape plus the
        numpy-canonical dtype name, so two spellings of one shape share one
        program."""
        return ((int(bucket),) + tuple(int(d) for d in row_shape),
                np.dtype(dtype).name)

    def program_for(self, bucket: int, x: np.ndarray) -> Callable:
        """The program of ``x``'s padded shape (built on first use); call
        it as ``program(x, fetch=site)``."""
        key = self._program_key(bucket, x.shape[1:], x.dtype)
        prog = self._compiled.get(key)
        if prog is None:
            prog = self._compile(bucket, x.shape[1:], x.dtype)
            self._compiled[key] = prog
        return prog

    def score(self, x: np.ndarray) -> np.ndarray:
        """Score one padded bucket-shaped batch -> host float32 rows,
        through the per-model circuit breaker."""
        return self.breaker.call(self._score, x)

    def _score(self, x: np.ndarray) -> np.ndarray:
        out = np.asarray(self.program_for(x.shape[0], x)(
            x, fetch="serve.score"))
        if out.ndim == 1:
            out = out[:, None]
        return np.asarray(out, np.float32)

    # -- residency ---------------------------------------------------------
    def resident_bytes(self) -> int:
        """Device bytes this entry pins on this device (0 when cold): the
        placed module's parameters and buffers (on a mesh, this rank's
        shards), plus any generate-lane KV arena (its shard)."""
        if self._module is None:
            return self.kv_arena_bytes
        return devmem.param_shard_bytes(self._module.state_dict()) \
            + self.kv_arena_bytes

    def built_programs(self) -> Dict[Tuple, Callable]:
        """Padded shape -> the program built for it."""
        return dict(self._compiled)

    @property
    def warm(self) -> bool:
        return self._apply is not None

    def evict(self) -> None:
        """Drop the programs, their memory pool AND the model's memoized
        module, so the device tensors they hold become collectable; on a
        mesh, release this entry's and the memo's holds on the placement
        (the last frees it on every rank)."""
        apply = self._apply
        self._apply = None
        self._module = None
        self._compiled.clear()
        self._pool = None
        if getattr(apply, "meshed", False):
            apply.release()
        self.model.release_placement()


class ModelRegistry:
    """Name -> :class:`ModelEntry`, LRU-bounded by ``runtime.device_cache_mb``.

    Thread-safe for registration and lookup; entry warm-up and scoring are
    serialized by the server's single executor thread.
    """

    def __init__(self, budget_mb: Optional[float] = None,
                 device: Optional[torch.device] = None):
        self._budget_mb = budget_mb
        self.device = (torch.device(device) if device is not None
                       else mmlconfig.resolve_device())
        self._entries: "OrderedDict[str, ModelEntry]" = OrderedDict()
        self._lock = threading.Lock()
        self.evictions = 0

    def budget_bytes(self) -> float:
        mb = self._budget_mb
        if mb is None:
            mb = float(mmlconfig.get("runtime.device_cache_mb"))
        return mb * 1e6

    def add(self, name: str, model, version: str = "v1") -> ModelEntry:
        with self._lock:
            if name in self._entries:
                raise ValueError(f"model {name!r} already registered")
            entry = ModelEntry(name, model, version=version,
                               device=self.device)
            self._entries[name] = entry
            return entry

    def replace(self, name: str, model, version: str) -> ModelEntry:
        """Atomically swap the entry behind ``name`` (the rollout cutover):
        lookups from the swap onward get the new version; a batch already
        holding the OLD entry finishes on it. The old entry is evicted.
        Unknown names register fresh. A replacement whose bytes cannot fit
        the budget raises :class:`PlacementOverBudget` before the old entry
        is touched."""
        projected = self.projected_bytes(model)
        budget = self.budget_bytes()
        if projected > budget:
            raise PlacementOverBudget(
                f"model {name!r} replacement rejected: projected bytes "
                f"{int(projected)} exceed the registry budget {int(budget)} "
                "(runtime.device_cache_mb); the current entry keeps serving")
        with self._lock:
            old = self._entries.pop(name, None)
            entry = ModelEntry(name, model, version=version,
                               device=self.device)
            self._entries[name] = entry
        if old is not None and old.warm:
            old.evict()
        return entry

    @staticmethod
    def projected_bytes(model) -> int:
        """Bytes ``model`` would pin on one device once warmed, from its
        host state alone (nothing placed): on its ``meshSpec``, each
        leaf's shard under the sharding rules. 0 for models without
        params."""
        params = (getattr(model, "_state", None) or {}).get("params")
        if params is None:
            return 0
        sizes = getattr(model, "_mesh_sizes", lambda: None)()
        return devmem.projected_shard_bytes(params, sizes)

    def get(self, name: str) -> ModelEntry:
        with self._lock:
            entry = self._entries.get(name)
            if entry is None:
                raise KeyError(
                    f"unknown model {name!r}; registered: {self.names()}")
            self._entries.move_to_end(name)   # MRU
            return entry

    def names(self) -> List[str]:
        return sorted(self._entries)

    def touch(self, entry: ModelEntry) -> None:
        """After warming ``entry``, evict LRU entries until the warm set
        fits the budget. ``entry`` itself is exempt — a single over-budget
        model still serves, it just evicts everyone else."""
        evicted: List[Tuple[str, int]] = []
        with self._lock:
            budget = self.budget_bytes()
            while self._resident() > budget:
                victim = next(
                    (e for e in self._entries.values()
                     if e.warm and e is not entry), None)
                if victim is None:
                    break
                freed = victim.resident_bytes()
                victim.evict()
                self.evictions += 1
                evicted.append((victim.name, freed))
            resident = self._resident()
            warm = [(e.name, e._module, e.kv_arena_bytes)
                    for e in self._entries.values()]
        ledger = devmem.get_ledger()
        for name, freed in evicted:
            ledger.on_eviction(name, freed, resident_bytes=resident,
                               budget_bytes=budget)
        # mirror the warm set into the ledger; embedding rows split out as
        # kind="table"
        for name, module, kv in warm:
            state = module.state_dict() if module is not None else None
            dense, table = devmem.split_param_shard_bytes(state)
            ledger.set_bytes(name, "params", dense)
            ledger.set_bytes(name, "table", table)
            ledger.set_bytes(name, "kv", kv)

    def _resident(self) -> int:
        return sum(e.resident_bytes() for e in self._entries.values())

    def resident_bytes(self) -> int:
        with self._lock:
            return self._resident()

    def release(self) -> None:
        """Close-time teardown: evict every entry and clear its lines from
        the device-memory ledger, so a closed server leaves no {model,
        kind} bytes behind."""
        with self._lock:
            entries = list(self._entries.values())
        ledger = devmem.get_ledger()
        for e in entries:
            if e.warm:
                e.evict()
            ledger.clear(e.name)

    def versions(self) -> Dict[str, str]:
        """Name -> served version."""
        with self._lock:
            return {n: e.version for n, e in sorted(self._entries.items())}

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "models": len(self._entries),
                "warm": sum(1 for e in self._entries.values() if e.warm),
                "resident_bytes": self._resident(),
                "evictions": self.evictions,
                "compiles": sum(e.compile_count
                                for e in self._entries.values()),
                "compile_cache_hits": sum(e.cache_hits
                                          for e in self._entries.values()),
            }
