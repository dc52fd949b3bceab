"""Mid-training checkpoint / resume for the trainer's state, on torch.save.

The port of ``mmlspark_tpu/parallel/checkpoint.py``, with its API. The
reference saved its sharded pytree through orbax; here one device's state
saves through ``torch.save``:

- **what a step holds**: ``module.state_dict()``, the torch optimizer's
  ``state_dict()``, the optimizer's host-side update count
  (``OptimizerState.count``, and a ``count`` the torch optimizer keeps
  itself, as ``Lamb`` and ``Adafactor`` do), the step, and the state of
  every generator the trainer has handed to a loss
  (``state["generators"]``, the trainer's own registry). The port's
  generators advance with each draw where the reference folded the step
  into its keys, so without them a resumed run that draws (dropout)
  could not be bit-equal.
- **in-place state**: the port's ``train_step`` updates the module, the
  optimizer and ``state["step"]`` in place, where JAX arrays were
  immutable. So :meth:`TrainCheckpointer.save` copies every tensor to
  the host — on the current stream, into pinned memory, then one counted
  wait (``checkpoint.snapshot``) — BEFORE it returns. Only the
  serialization and the file write run in the background; the next step
  cannot tear the checkpoint.
- **commit**: a step is written into ``<step>.tmp-<pid>/``, its file and
  directory fsynced, then renamed to ``<step>/``: a step is listed only
  once it has committed, so a kill at any point leaves the previous steps
  or the new one, never a half-step. A stale ``<step>/`` (a dead run's
  save that landed after a restore listed the steps) is replaced, steps
  beyond ``max_to_keep`` are pruned oldest first, and a step that fails
  to load is moved aside as ``corrupt-<step>`` (:meth:`quarantine_step`).
- **restore** builds the target with ``trainer.init(init_fn)`` and loads
  into it with ``map_location=trainer.device``: the module's tensors are
  copied into the live parameters, which keep their layout (channels-last
  on a card).
- **on a mesh** (a state from a meshed trainer, which carries its
  ``layout``) every rank gathers the whole of each split parameter and
  optimizer state tensor (``optim.state_sharding`` says how each is
  split), and rank 0 alone writes them: a gather to rank 0, one file a
  step, the same as a one-device checkpoint's. A restore reads the whole
  tensors on every rank and keeps the shards of the TARGET trainer's
  mesh, so a step saved on one mesh shape restores on another (4x1 ->
  2x2 -> 1x4) or on one device, and a one-device step on a mesh. Every
  rank saves, waits and restores together: :meth:`wait` (so a save with
  ``wait=True``, and a restore) meets the other ranks at a barrier after
  rank 0's commits, so none reads a step before it is committed.

Usage::

    ckpt = TrainCheckpointer(dir, max_to_keep=3)
    state, resumed = ckpt.restore_or_init(trainer, init_fn)
    start_step = ckpt.latest_step() or 0
    for step, batch in enumerate(batches, start=start_step + 1):
        state, metrics = trainer.train_step(state, trainer.put_batch(batch))
        ckpt.maybe_save(state, every=100, step=step)
    ckpt.save(state, wait=True)
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import wait as futures_wait
from collections.abc import Mapping
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from mmlspark_tpu_torch.observability import events as obsevents
from mmlspark_tpu_torch.observability import metrics as obsmetrics
from mmlspark_tpu_torch.observability import syncs
from mmlspark_tpu_torch.observability.spans import span
from mmlspark_tpu_torch.parallel.sharding import (
    local_state_dict, mine, whole, whole_state_dict,
)
from mmlspark_tpu_torch.reliability.faults import fault_site
from mmlspark_tpu_torch.utils.logging import get_logger

_LOG = get_logger("parallel.checkpoint")

_STATE_FILE = "state.pt"
_TMP_RE = re.compile(r"^(\d+)\.tmp-(\d+)$")


def _process_index() -> int:
    """This process's rank in an initialized ``torch.distributed`` group,
    else 0 (the reference's ``jax.process_index()``)."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def _snapshot(obj: Any, pinned: bool) -> Any:
    """Host copy of a nest of dicts / lists / tuples of tensors. Device
    tensors copy into pinned host memory without blocking (the caller
    waits once for all of them); host tensors are cloned, so the copy
    never aliases state the next step updates in place."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if t.device.type == "cpu":
            return t.clone()
        host = torch.empty_like(t, device="cpu", pin_memory=pinned)
        host.copy_(t, non_blocking=pinned)
        return host
    if isinstance(obj, Mapping):
        return {k: _snapshot(v, pinned) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_snapshot(v, pinned) for v in obj)
    return obj


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)  # lint: allow-process (signal 0: a liveness probe)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


class TrainCheckpointer:
    """torch.save-backed checkpoint manager for DistributedTrainer state."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self._max_to_keep = max_to_keep
        self._closed = False
        self._lock = threading.Lock()
        self._pending: List[Future] = []
        self._inflight: set = set()
        self._error: Optional[BaseException] = None
        self.last_save: Dict[str, float] = {}
        self._meshed = False     # a meshed state was saved or restored
        os.makedirs(self.directory, exist_ok=True)
        self._sweep_torn_writes()
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="mmlspark-tpu-torch-ckpt")

    def _sweep_torn_writes(self) -> None:
        """Remove ``<step>.tmp-<pid>`` directories of processes that no
        longer run: a save killed before its rename. Never listed as a
        step, they would only hold disk."""
        for name in os.listdir(self.directory):
            m = _TMP_RE.match(name)
            if m and int(m.group(2)) != os.getpid() \
                    and not _pid_alive(int(m.group(2))):
                _LOG.warning("removing torn checkpoint write %s", name)
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    # -- write --------------------------------------------------------------
    def save(self, state: Dict[str, Any], step: Optional[int] = None,
             wait: bool = False) -> int:
        """Save (async by default); step defaults to ``state['step']``.
        Returns once the state is on the host: the caller may step on. On
        a mesh every rank calls it (the gathers are collective) and rank 0
        writes."""
        if step is None:
            step = int(syncs.device_get(state["step"], "checkpoint.step"))
        layout = state.get("layout")
        self._meshed = self._meshed or layout is not None
        if layout is not None and _process_index() != 0:
            with span("checkpoint", "save", step=step):
                self._host_state(state, step)
            if wait:
                self.wait()
            return step
        stale = os.path.join(self.directory, str(step))
        if os.path.isdir(stale):
            # A dead run's save for this step committed after restore
            # listed the steps. The state written now was regenerated
            # deterministically from an older checkpoint, so it supersedes
            # the leftover.
            _LOG.warning("save(%d): removing stale step dir %s", step, stale)
            shutil.rmtree(stale)
        with span("checkpoint", "save", step=step):
            fault_site("checkpoint.save")
            t0 = time.perf_counter()
            payload = self._host_state(state, step)
            snapshot_s = time.perf_counter() - t0
            fault_site("checkpoint.save.commit")
            with self._lock:
                self._inflight.add(step)
            fut = self._pool.submit(self._write, payload, step, snapshot_s)
            with self._lock:
                self._pending.append(fut)
            if wait:
                self.wait()
        obsmetrics.counter("checkpoint.saves").inc()
        return step

    def _host_state(self, state: Dict[str, Any], step: int) -> Dict[str, Any]:
        """Everything a resume needs, copied to the host; returns after the
        copies have landed (one counted wait per device)."""
        opt = state["optimizer"]
        if state.get("layout") is not None:
            device_state = {"module": whole_state_dict(state["module"]),
                            "optimizer": _whole_optimizer(opt.torch)}
        else:
            device_state = {
                "module": state["module"].state_dict(),
                "optimizer": opt.torch.state_dict(),
            }
        devices = {t.device for t in _tensors(device_state)
                   if t.device.type == "cuda"}
        payload = _snapshot(device_state, pinned=bool(devices))
        for d in devices:
            syncs.synchronize("checkpoint.snapshot", d)
        payload["optimizer_count"] = int(opt.count)
        own = getattr(opt.torch, "count", None)
        payload["optimizer_own_count"] = None if own is None else int(own)
        payload["step"] = int(step)
        payload["generators"] = {
            int(seed): gen.get_state().clone()
            for seed, gen in (state.get("generators") or {}).items()}
        return payload

    def _write(self, payload: Dict[str, Any], step: int,
               snapshot_s: float) -> None:
        t0 = time.perf_counter()
        tmp = os.path.join(self.directory, f"{step}.tmp-{os.getpid()}")
        final = os.path.join(self.directory, str(step))
        try:
            if os.path.isdir(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            path = os.path.join(tmp, _STATE_FILE)
            with open(path, "wb") as f:
                torch.save(payload, f)
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(tmp)
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            _fsync_dir(self.directory)
            self._prune()
        except BaseException as e:
            with self._lock:
                if self._error is None:
                    self._error = e
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        finally:
            with self._lock:
                self._inflight.discard(step)
        self.last_save = {"step": step, "snapshot_s": snapshot_s,
                          "write_s": time.perf_counter() - t0,
                          "bytes": float(os.path.getsize(
                              os.path.join(final, _STATE_FILE)))}

    def _prune(self) -> None:
        steps = self.all_steps()
        if self._max_to_keep and len(steps) > self._max_to_keep:
            for s in steps[:len(steps) - self._max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(s)),
                              ignore_errors=True)

    def wait(self) -> None:
        """Block until every in-flight async save has committed; raises
        the first background failure (once). Once this checkpointer has
        handled a meshed state, every rank calls it and they meet at a
        barrier after rank 0's commits, so all list the same steps."""
        with self._lock:
            pending, self._pending = self._pending, []
        # a failed write is recorded in self._error by _write
        futures_wait(pending)
        with self._lock:
            err, self._error = self._error, None
        if self._meshed:
            _barrier()
        if err is not None:
            raise err

    def latest_committed(self, state: Optional[Dict[str, Any]] = None
                         ) -> Optional[int]:
        """The newest committed step once every in-flight save has
        committed: :meth:`wait`, then the listing. On a mesh (this
        checkpointer has handled a meshed state, or ``state`` is one) the
        ranks meet again after listing, so every rank reads the same step:
        a rank that listed late could otherwise see a step that rank 0
        saved after the others listed, and skip the save (a collective)
        they then make."""
        meshed = self._meshed or (state is not None
                                  and state.get("layout") is not None)
        self.wait()
        step = self.latest_step()
        if meshed:
            _barrier()
        return step

    def maybe_save(self, state: Dict[str, Any], every: int, step: int,
                   wait: bool = False) -> Optional[int]:
        """Save when ``step`` (the HOST loop counter — passing it avoids a
        device sync per step) is a positive multiple of ``every``."""
        if every > 0 and step > 0 and step % every == 0:
            return self.save(state, step=step, wait=wait)
        return None

    # -- run metadata -------------------------------------------------------
    # Small facts about HOW the run draws its data (e.g. the batch-order
    # mode) that a resume must replay identically. JSON sidecar next to
    # the checkpoints; process 0 writes, every process reads.
    _META = "mmlspark_meta.json"

    def put_meta(self, **meta: Any) -> None:
        if _process_index() != 0:
            return
        path = os.path.join(self.directory, self._META)
        data = self.get_meta()
        data.update(meta)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, path)

    def get_meta(self) -> Dict[str, Any]:
        # Only a MISSING sidecar means "no metadata"; any other read/parse
        # failure must surface — callers pin resume behavior on this.
        try:
            with open(os.path.join(self.directory, self._META)) as f:
                return json.load(f)
        except FileNotFoundError:
            return {}

    # -- input-pipeline state ------------------------------------------------
    # The streaming pipeline's iterator snapshot (data/pipeline.py
    # state_dict) saves NEXT TO each checkpoint step so
    # ResilientTrainLoop.run_dataset resumes the batch stream mid-epoch
    # bit-identically. Per process and per step, so a quarantined step
    # falls back to the older step's matching snapshot. The file name and
    # wrapper are the reference's.
    _DATA_STATE_RE = re.compile(r"data_state-(\d+)\.p\d+\.json$")

    def _data_state_path(self, step: int) -> str:
        return os.path.join(
            self.directory, f"data_state-{step}.p{_process_index()}.json")

    def put_data_state(self, step: int, state: Dict[str, Any]) -> str:
        """Persist an input-pipeline ``state_dict`` for ``step`` (call it
        just BEFORE ``save(step)``: an orphan snapshot for an uncommitted
        step is harmless, a committed step without its snapshot loses
        mid-epoch resume). Wrapped with a sha256 of its canonical JSON,
        verified at :meth:`get_data_state`. Returns the written path."""
        path = self._data_state_path(step)
        body = json.dumps(state, sort_keys=True)
        wrapper = {"sha256": hashlib.sha256(body.encode()).hexdigest(),
                   "state": state}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(wrapper, f, sort_keys=True)
        os.replace(tmp, path)
        self._gc_data_state(keep_step=step)
        return path

    def get_data_state(self, step: int) -> Optional[Dict[str, Any]]:
        """This process's pipeline snapshot for ``step``, or None when the
        checkpoint has none OR the sidecar fails integrity checks. A
        corrupt sidecar is QUARANTINED (renamed aside) — resuming the
        stream from its beginning costs duplicate batches; resuming from
        a silently corrupt cursor is wrong forever."""
        path = self._data_state_path(step)
        try:
            with open(path) as f:
                payload = json.load(f)
        except FileNotFoundError:
            return None
        except ValueError:
            return self._quarantine_data_state(path, "unparseable JSON")
        if not (isinstance(payload, dict) and "sha256" in payload
                and "state" in payload):
            # pre-sha256 sidecar (older writer): load it as-is
            return payload if isinstance(payload, dict) else \
                self._quarantine_data_state(path, "not a JSON object")
        body = json.dumps(payload["state"], sort_keys=True)
        actual = hashlib.sha256(body.encode()).hexdigest()
        if actual != payload["sha256"]:
            return self._quarantine_data_state(
                path, f"sha256 {actual[:12]} != recorded "
                f"{str(payload['sha256'])[:12]}")
        return payload["state"]

    def _quarantine_data_state(self, path: str, why: str) -> None:
        quarantined = os.path.join(
            os.path.dirname(path), "corrupt-" + os.path.basename(path))
        _LOG.warning("data-state sidecar %s failed verification (%s); "
                     "quarantined to %s — the input stream restarts",
                     path, why, quarantined)
        try:
            os.replace(path, quarantined)
        except OSError as e:   # already moved by a concurrent reader
            _LOG.debug("data-state quarantine skipped (%s)", e)
        obsmetrics.counter("checkpoint.data_state_quarantined").inc()
        if obsevents.events_enabled():
            obsevents.emit("event", "checkpoint.data_state_quarantine",
                           path=path, reason=why)
        return None

    def _gc_data_state(self, keep_step: int) -> None:
        """Drop snapshots of steps that were pruned (max_to_keep); the
        step being written now, and any still in flight, are kept."""
        with self._lock:
            inflight = set(self._inflight)
        keep = set(self.all_steps()) | inflight | {keep_step}
        for name in os.listdir(self.directory):
            m = self._DATA_STATE_RE.match(name)
            if m and int(m.group(1)) not in keep:
                try:
                    os.remove(os.path.join(self.directory, name))
                except OSError as e:  # another process may GC concurrently
                    _LOG.debug("data-state GC skipped %s (%s)", name, e)

    # -- read ---------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        """The committed steps, ascending: directories named by a bare
        integer (an in-flight ``.tmp-`` write and a ``corrupt-`` step are
        not steps)."""
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def restore(self, trainer, init_fn: Callable[[], torch.nn.Module],
                step: Optional[int] = None) -> Dict[str, Any]:
        """Restore ``step`` (default latest) into a state freshly built by
        ``trainer.init(init_fn)`` on ``trainer.device``."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint found under {self.directory}")
        with span("checkpoint", "restore", step=step):
            fault_site("checkpoint.restore")
            state = trainer.init(init_fn)
            meshed = state.get("layout") is not None
            if meshed:
                self._meshed = True
                self.wait()
            with open(os.path.join(self.directory, str(step), _STATE_FILE),
                      "rb") as f:
                payload = torch.load(
                    f, map_location="cpu" if meshed else trainer.device,
                    weights_only=True)
            opt = state["optimizer"]
            if meshed:
                payload["module"] = local_state_dict(state["module"],
                                                     payload["module"],
                                                     state["layout"])
                payload["optimizer"] = _local_optimizer(
                    opt.torch, payload["optimizer"], state["layout"])
            state["module"].load_state_dict(payload["module"], strict=True)
            opt.torch.load_state_dict(payload["optimizer"])
            opt.count = int(payload["optimizer_count"])
            if payload["optimizer_own_count"] is not None:
                opt.torch.count = int(payload["optimizer_own_count"])
            state["step"].fill_(int(payload["step"]))
            for seed, gen_state in payload["generators"].items():
                trainer._generator(int(seed)).set_state(gen_state.cpu())  # lint: allow-sync (the loaded state is a host tensor)
        obsmetrics.counter("checkpoint.restores").inc()
        return state

    def restore_or_init(self, trainer, init_fn: Callable[[], torch.nn.Module]
                        ) -> Tuple[Dict[str, Any], bool]:
        """(state, resumed): latest checkpoint if one exists, else fresh
        init."""
        if self.latest_step() is None:
            return trainer.init(init_fn), False
        return self.restore(trainer, init_fn), True

    # -- recovery -----------------------------------------------------------
    def quarantine_step(self, step: int) -> str:
        """Move a bad step's directory aside (``corrupt-<step>``: a
        non-numeric name, so it is no longer listed). The data is kept for
        forensics, not deleted. Returns the quarantine path."""
        src = os.path.join(self.directory, str(step))
        dst = os.path.join(self.directory, f"corrupt-{step}")
        n = 0
        while os.path.exists(dst):
            n += 1
            dst = os.path.join(self.directory, f"corrupt-{step}.{n}")
        if os.path.exists(src):
            os.rename(src, dst)
        else:
            _LOG.warning("quarantine_step(%d): %s does not exist", step, src)
        obsmetrics.counter("checkpoint.quarantines").inc()
        if obsevents.events_enabled():
            obsevents.emit("event", "checkpoint.quarantine", step=step,
                           path=dst)
        return dst

    def reload(self) -> None:
        """Pick up external directory changes. Steps are listed from the
        directory on every call, so this only reopens a closed
        checkpointer (the reference recreated its orbax manager)."""
        if self._closed:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="mmlspark-tpu-torch-ckpt")
        self._closed = False

    def close(self) -> None:
        """Idempotent close. A second call is a no-op; the FIRST call still
        raises a failed background save (it must not vanish into
        interpreter shutdown), while the writer is released either way."""
        if self._closed:
            return
        self._closed = True
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)


def _barrier() -> None:
    import torch.distributed as dist
    dist.barrier()


def _opt_params(opt: torch.optim.Optimizer) -> List[torch.nn.Parameter]:
    """The optimizer's parameters in its ``state_dict`` index order."""
    return [p for group in opt.param_groups for p in group["params"]]


def _whole_optimizer(opt: torch.optim.Optimizer) -> Dict[str, Any]:
    from mmlspark_tpu_torch.parallel.optim import state_sharding
    params = _opt_params(opt)
    sd = opt.state_dict()
    sd["state"] = {
        i: {k: whole(v, state_sharding(params[i], k, v.shape),
                     getattr(params[i], "_mesh_layout", None))
            if torch.is_tensor(v) else v for k, v in st.items()}
        for i, st in sd["state"].items()}
    return sd


def _local_optimizer(opt: torch.optim.Optimizer, whole: Dict[str, Any],
                     layout) -> Dict[str, Any]:
    from mmlspark_tpu_torch.parallel.optim import state_sharding
    params = _opt_params(opt)
    out = dict(whole)
    out["state"] = {
        i: {k: mine(v, state_sharding(params[int(i)], k, v.shape,
                                      whole=True), layout)
            if torch.is_tensor(v) else v for k, v in st.items()}
        for i, st in whole["state"].items()}
    return out


def _tensors(obj: Any):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, Mapping):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


__all__ = ["TrainCheckpointer"]
