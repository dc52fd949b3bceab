"""ResilientTrainLoop: preemption-tolerant training driver.

The port of ``mmlspark_tpu/reliability/resilient.py``. It composes
``DistributedTrainer`` + ``TrainCheckpointer`` into a loop whose contract
is: kill the process at ANY point — mid-step, mid-checkpoint-write —
rerun the same program, and the resumed run's final state is
bit-identical to an uninterrupted run's.

What makes that hold:

- batches come from a DETERMINISTIC ``batch_fn(step)`` (step -> host
  batch) or a resumable ``data.Dataset`` whose ``state_dict`` saves with
  every checkpoint, so a restart replays the exact data order;
- the checkpoint carries the trainer's generators, so a loss that draws
  (dropout) repeats its draws after a restart;
- checkpoint saves commit atomically (``TrainCheckpointer`` writes into a
  temporary directory and renames), so a crash mid-write leaves either
  the previous steps or the new one — never a half-step;
- restore VALIDATES: if the newest checkpoint fails to load, it is
  quarantined (renamed aside, preserved for forensics) and restore falls
  back to the next-newest step, down to a fresh init when none survive.

The elastic-mesh lever, :meth:`ResilientTrainLoop.reshard_to`, moves a
run onto a new mesh of the same ranks at a step boundary: drain to a
checkpoint, build the trainer on the new ``DeviceMesh``, restore across
mesh shapes, go on (the stage, expert and table leaves of slice 6b-i
too).

``run_dataset`` on a mesh feeds each rank its own stream: every rank
iterates its own pipeline (typically a ``FileSource(process_shard=True)``
shard) and uploads its local rows of each global batch
(``put_batch(local=True)``); each rank saves and restores its own
``data_state-<step>.p<rank>.json``, so a restart restores every rank's
cursor. The ranks agree, at the start, on the step they resumed from and
the steps to run, and before each step on whether every rank has a
batch: a rank whose shard runs dry first raises on every rank, with a
message that names it and the step, instead of leaving the others
waiting in a collective.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional, Tuple

from mmlspark_tpu_torch.reliability import preemption
from mmlspark_tpu_torch.utils.logging import get_logger

_LOG = get_logger("reliability.resilient")


class ResilientTrainLoop:
    """Crash-safe driver over a trainer + checkpointer pair.

    ``save_every`` is the checkpoint cadence in steps (the crash-loss
    window); the final step always commits with ``wait=True`` so a clean
    exit never loses the tail. ``trainer_factory(mesh) -> trainer``
    enables :meth:`reshard_to`.
    """

    def __init__(self, trainer, checkpointer,
                 init_params_fn: Callable[[], Any], save_every: int = 1,
                 trainer_factory: Optional[Callable[[Any], Any]] = None):
        self.trainer = trainer
        self.ckpt = checkpointer
        self.init_params_fn = init_params_fn
        self.save_every = save_every
        self.trainer_factory = trainer_factory
        self._reshard_lock = threading.Lock()
        self._pending_reshard: Optional[str] = None

    # -- elastic mesh --------------------------------------------------------
    def reshard_to(self, mesh_shape: str) -> None:
        """Request a mid-run mesh change (``'4x1'``, ``'2x2'``, ...), the
        same ranks laid out anew.

        Thread-safe and asynchronous: the request is honoured at the next
        step boundary, where the loop drains to a consistent checkpoint,
        rebuilds the trainer with ``trainer_factory`` on the new
        ``DeviceMesh``, restores the state across mesh shapes and goes on
        with the same batches. Every rank must make the same request
        before the same step. Needs ``trainer_factory`` (raises at once
        otherwise: a request that could never be honoured is not
        accepted)."""
        if self.trainer_factory is None:
            raise RuntimeError(
                "reshard_to needs a trainer_factory(mesh) -> trainer; "
                "construct ResilientTrainLoop with one")
        from mmlspark_tpu_torch.parallel.mesh import parse_mesh_shape
        parse_mesh_shape(mesh_shape)
        with self._reshard_lock:
            self._pending_reshard = mesh_shape

    def _take_pending_reshard(self) -> Optional[str]:
        with self._reshard_lock:
            shape, self._pending_reshard = self._pending_reshard, None
            return shape

    def _maybe_reshard(self, state: Any, step: int) -> Any:
        """The step-boundary rendezvous: when a reshard is pending, drain
        to a checkpoint of ``step``, swap the trainer onto the new mesh
        and restore the state into its placement."""
        if step <= 0:
            return state   # nothing checkpointable yet; stays pending
        shape = self._take_pending_reshard()
        if shape is None:
            return state
        from mmlspark_tpu_torch.parallel.mesh import (make_mesh,
                                                      parse_mesh_shape)
        _LOG.warning("resharding at step %d to mesh %s", step, shape)
        if self.ckpt.latest_committed(state) != step:
            self.ckpt.save(state, step=step, wait=True)
        self.trainer = self.trainer_factory(make_mesh(parse_mesh_shape(shape)))
        state = self.ckpt.restore(self.trainer, self.init_params_fn,
                                  step=step)
        from mmlspark_tpu_torch.observability import events, metrics
        metrics.counter("reliability.reshards").inc()
        if events.events_enabled():
            events.emit("event", "train.reshard", step=step,
                        mesh_shape=shape)
        return state

    def restore_or_init(self) -> Tuple[Dict[str, Any], int]:
        """(state, start_step): newest VALID checkpoint, else fresh init.

        A checkpoint that fails to restore is quarantined (kept under a
        ``corrupt-<step>`` name, no longer listed) and the next-newest step
        is tried, so a torn write or bitrot in the latest step costs
        ``save_every`` steps of progress instead of the whole run.
        """
        while True:
            step = self.ckpt.latest_step()
            if step is None:
                return self.trainer.init(self.init_params_fn), 0
            try:
                state = self.ckpt.restore(self.trainer, self.init_params_fn,
                                          step=step)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                # any load failure means this step is unusable on THIS
                # disk; quarantine and fall back rather than crash the run
                quarantined = self.ckpt.quarantine_step(step)
                _LOG.warning(
                    "checkpoint step %d failed to restore (%s: %s); "
                    "quarantined to %s, falling back to %s", step,
                    type(e).__name__, e, quarantined,
                    self.ckpt.latest_step())
                from mmlspark_tpu_torch.observability import events
                if events.events_enabled():
                    events.emit("event", "restore.fallback", step=step,
                                error=f"{type(e).__name__}: {e}",
                                fallback=self.ckpt.latest_step())
                continue
            return state, step

    def run(self, batch_fn: Callable[[int], Dict], total_steps: int,
            rng: Optional[Any] = None) -> Dict[str, Any]:
        """Train to ``total_steps`` (1-based), resuming from the newest
        valid checkpoint. ``batch_fn(step)`` must be deterministic in
        ``step``. ``rng`` is the trainer's seed (default 0) or a
        ``torch.Generator``."""
        rng = 0 if rng is None else rng
        state, start = self.restore_or_init()
        if start > 0:
            _LOG.info("resuming from checkpoint step %d", start)
        if start >= total_steps:
            return state
        for step in range(start + 1, total_steps + 1):
            if preemption.preempted():
                return self._drain(state, step - 1)
            state = self._maybe_reshard(state, step - 1)
            batch = self.trainer.put_batch(batch_fn(step))
            state, _metrics = self.trainer.train_step(state, batch, rng)
            self.ckpt.maybe_save(state, every=self.save_every, step=step)
        # final commit: wait for any in-flight async save first so a
        # cadence-aligned last step doesn't double-save
        if self.ckpt.latest_committed(state) != total_steps:
            self.ckpt.save(state, step=total_steps, wait=True)
        return state

    def _drain(self, state: Dict[str, Any], step: int,
               data_state: Any = None) -> Dict[str, Any]:
        """Preemption exit: force a synchronous final checkpoint (plus the
        input-pipeline sidecar when streaming) so the next run resumes from
        THIS step instead of the last cadence-aligned save."""
        reason = preemption.preemption_reason() or "preempted"
        _LOG.warning("preempted (%s) at step %d: committing a final "
                     "checkpoint before exit", reason, step)
        if step > 0 and self.ckpt.latest_committed(state) != step:
            if data_state is not None:
                self.ckpt.put_data_state(step, data_state)
            self.ckpt.save(state, step=step, wait=True)
        from mmlspark_tpu_torch.observability import events, metrics
        metrics.counter("reliability.preemption_drains").inc()
        if events.events_enabled():
            events.emit("event", "preemption.drain", step=step,
                        reason=reason, kind="train")
        return state

    def run_dataset(self, data, total_steps: int,
                    rng: Optional[Any] = None) -> Dict[str, Any]:
        """Crash-safe training over a streaming input pipeline.

        ``data`` is a ``mmlspark_tpu_torch.data.Dataset`` (typically ending
        in ``.batch(...).repeat(...)``) or an already-built
        ``PipelineIterator``. The pipeline's ``state_dict`` persists with
        EVERY checkpoint (``TrainCheckpointer.put_data_state``), so a
        restart restores both the state and the input cursor and replays
        the interrupted batch stream mid-epoch, bit for bit. The snapshot
        writes BEFORE the (async) checkpoint save: an orphan snapshot is
        harmless, a committed step without one would restart the stream.
        """
        from mmlspark_tpu_torch.data.pipeline import Dataset
        mesh = getattr(self.trainer, "mesh", None)
        lockstep = _Lockstep(mesh) if mesh is not None else None
        rng = 0 if rng is None else rng
        state, start = self.restore_or_init()
        if start > 0:
            _LOG.info("resuming from checkpoint step %d", start)
        if lockstep is not None:
            lockstep.agree_on_run(start, total_steps)
        it = data.iter() if isinstance(data, Dataset) else data
        try:
            if start > 0:
                snapshot = self.ckpt.get_data_state(start)
                if snapshot is not None:
                    it.load_state_dict(snapshot)
                else:
                    _LOG.warning(
                        "checkpoint step %d has no input-pipeline snapshot; "
                        "the stream restarts from its beginning", start)
            if start >= total_steps:
                return state
            for step in range(start + 1, total_steps + 1):
                if preemption.preempted():
                    return self._drain(state, step - 1,
                                       data_state=it.state_dict())
                try:
                    host = next(it)
                except StopIteration:
                    host = None
                if lockstep is not None:
                    lockstep.agree_on_batch(host is not None, step,
                                            total_steps)
                if host is None:
                    raise ValueError(
                        f"dataset exhausted at step {step} of {total_steps};"
                        " add .repeat() for multi-epoch runs")
                batch = (self.trainer.put_batch(host) if lockstep is None
                         else self.trainer.put_batch(host, local=True))
                state, _metrics = self.trainer.train_step(state, batch, rng)
                if self.save_every > 0 and step % self.save_every == 0:
                    self.ckpt.put_data_state(step, it.state_dict())
                    self.ckpt.save(state, step=step)
            if self.ckpt.latest_committed(state) != total_steps:
                self.ckpt.put_data_state(total_steps, it.state_dict())
                self.ckpt.save(state, step=total_steps, wait=True)
            return state
        finally:
            closer = getattr(it, "close", None)
            if callable(closer):
                closer()


class _Lockstep:
    """The agreements of a meshed ``run_dataset``, over a gloo group of the
    mesh's ranks (host flags, whatever the trainer's backend): made once,
    at the start of the run, by every rank."""

    def __init__(self, mesh):
        import torch.distributed as dist
        self._dist = dist
        ranks = sorted(int(r) for r in mesh.mesh.flatten().tolist())  # lint: allow-sync (host ranks)
        self.group = dist.new_group(ranks, backend="gloo")
        self.rank = dist.get_rank()

    def _gather(self, value) -> list:
        from mmlspark_tpu_torch.parallel.collectives import host_all_gather
        return host_all_gather(value, self.group)

    def agree_on_run(self, start: int, total_steps: int) -> None:
        """Every rank resumed from the same step and runs to the same
        one."""
        seen = self._gather((self.rank, int(start), int(total_steps)))
        if len({(s, t) for _, s, t in seen}) > 1:
            raise RuntimeError(
                "the ranks of a meshed run_dataset disagree on (resumed "
                f"step, total steps): {sorted(seen)} as (rank, start, "
                "total)")

    def agree_on_batch(self, has_batch: bool, step: int,
                       total_steps: int) -> None:
        """Raise on every rank when any rank's stream ran dry before
        ``step``."""
        import torch
        flag = torch.tensor([1 if has_batch else 0], dtype=torch.int32)
        self._dist.all_reduce(flag, op=self._dist.ReduceOp.MIN,
                              group=self.group)
        if int(flag.item()) == 1:  # lint: allow-sync (a gloo flag on the host)
            return
        dry = [r for r, ok in self._gather((self.rank, has_batch)) if not ok]
        raise ValueError(
            f"rank(s) {dry} ran out of data at step {step} of "
            f"{total_steps} in a meshed run_dataset; every rank's stream "
            "must give the same number of batches (add .repeat(), or "
            "balance the shards)")
