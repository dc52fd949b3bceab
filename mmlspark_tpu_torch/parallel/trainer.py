"""DistributedTrainer and DeviceEpochCache: the training step on one device.

The port of ``mmlspark_tpu/parallel/trainer.py``. There, one jitted XLA
program ran forward, backward, allreduce and optimizer over a device mesh;
here the step is eager PyTorch on ``runtime.device`` (one card), with the
same contracts:

- **state**: :meth:`DistributedTrainer.init` returns ``{"module",
  "optimizer", "step", "generators"}``: the ``nn.Module`` with fp32
  master parameters, the built optimizer (``parallel/optim.py``), a
  device int32 step counter, and the trainer's generators by seed (what a
  checkpoint must carry for a resumed run's draws to repeat). Steps
  update them in place (PyTorch's way; JAX returned new arrays) and
  return the same dict.
- **loss**: ``loss_fn(module, batch, gen) -> scalar fp32 tensor``, where
  ``gen`` is a ``torch.Generator`` on the device, seeded once from the
  ``rng`` the caller passes and advancing with every draw.
- **no host read in the step**: the loss lands in a device-resident
  metrics ring at slot ``step % train.metrics_flush_steps`` with a device
  index, and the ring is read once per flush interval (one counted sync,
  ``trainer.flush``) so no step's loss is overwritten unread. Nothing in
  the step calls ``.item()``, ``float()`` or ``bool()`` on a device
  tensor. The reference also used the flush to bound the dispatch depth
  of the multi-device CPU runtime; CUDA bounds its own launch queue, so
  here the flush is only the ring's read.
- **FLOPs per step** come from ``torch.utils.flop_counter.FlopCounterMode``
  on the first step (the reference read XLA's cost analysis).
- ``accum_steps`` splits a batch into microbatches whose gradients are
  summed and divided by the count, as the reference's scan did; ``remat``
  recomputes the forward in the backward (``torch.utils.checkpoint``).

**On a mesh** (``mesh=``, or the launcher's ``runtime.mesh`` once a
process group is joined) each rank runs the step on its own device and
the collectives GSPMD inserted for the reference are written out
(``parallel/collectives.py``):

- :meth:`DistributedTrainer.init` builds the module on the host, then
  moves to the device only the shard of each parameter its rank holds
  (``parallel/sharding.py``'s rules; no device ever holds a whole split
  leaf) and binds the modules that compute on their shards: each
  module's ``bind_mesh`` returns the leaves it claims with the axes it
  keeps split (the transformer's ``tensor`` split, the MoE's ``expert``
  banks, a pipeline ``StageStack``'s ``pipe`` split, the DLRM's row-split
  tables), and every other split (a claimed leaf's other axes included)
  is gathered for its use and its gradient scattered back. A module may
  list ``summed_grads``: leaves whose gradient it already summed over the
  data ranks (the DLRM's sparse table gradient), which leave the data
  all-reduce and are divided by the ranks' count like every gradient;
- the loss is the mean over the GLOBAL batch: each rank's ``loss_fn``
  sees its block of the batch (:meth:`put_batch`, a sequence slice under
  ``seq_axis``), the gradients are summed over the ranks that saw other
  data (``data``, ``fsdp``, and ``seq`` when the sequence is split) and
  divided by their count, and the metrics ring holds the global mean,
  the same on every rank. ``loss_fn`` returns its block's mean (or, for
  uneven shares, ``sharding.global_mean``; the LM's
  ``transformer.next_token_loss``);
- no host read in the step, as on one device: on NCCL the collectives
  queue on the card. gloo (ranks sharing one card, or the CPU) waits on
  the host for its transfers, counted apart in
  ``collectives.host_copies()``.
"""
from __future__ import annotations

import contextlib
import warnings
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.data.pipeline import Dataset
from mmlspark_tpu_torch.data.prefetch import DevicePrefetcher
from mmlspark_tpu_torch.parallel import collectives
from mmlspark_tpu_torch.parallel import mesh as meshlib
from mmlspark_tpu_torch.parallel import sharding
from mmlspark_tpu_torch.observability import events as obsevents
from mmlspark_tpu_torch.observability import metrics as obsmetrics
from mmlspark_tpu_torch.observability import syncs as obssyncs
from mmlspark_tpu_torch.observability.spans import span
from mmlspark_tpu_torch.reliability import watchdog as _watchdog
from mmlspark_tpu_torch.reliability.faults import fault_site
from mmlspark_tpu_torch.utils import config as mmlconfig
from mmlspark_tpu_torch.utils.logging import MetricLogger

LossFn = Callable[[torch.nn.Module, Dict[str, torch.Tensor],
                   torch.Generator], torch.Tensor]


def _device(device) -> torch.device:
    if device is None:
        return mmlconfig.resolve_device()
    return torch.device(device)


def _fold_in(seed: int, epoch: int) -> int:
    """One generator seed per (seed, epoch): a fixed 64-bit mix, so an
    epoch's permutation is the same in every run and differs across
    epochs."""
    return (int(seed) * 0x9E3779B97F4A7C15 + int(epoch) + 1) % (1 << 63)


def to_device(x, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device``. To a card it is staged in
    pinned memory and copied with ``non_blocking=True``, so the copy
    overlaps the work already queued on the stream."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class DeviceEpochCache:
    """Device-resident epoch: one host->device transfer, batches sliced on
    the device.

    Each column is reshaped on the host to ``(steps, batch, ...)`` and
    uploaded once; an epoch's batches are then views ``epoch[i]`` of the
    resident tensor, with zero steady-state transfer. Rows beyond
    ``steps * batch_size`` are dropped with a warning: callers that need
    the tail pad and mask it first (``train/learners.py::_pad_xyw``).

    ``shuffle=True`` permutes the rows once per epoch on the device with a
    permutation drawn from a ``torch.Generator`` seeded from ``(seed,
    epoch)``: the same seed and epoch give the same order in every run
    (the reference's ``fold_in(seed, epoch)`` contract; the orders
    themselves differ from ``jax.random``'s).

    On a ``mesh``, ``batch_size`` is the global batch and each rank
    uploads only its block of every batch (``local_batch`` rows, and
    under ``seq_axis`` its slice of the third dim of arrays of rank > 2),
    once; a shuffled epoch keeps the global rows on the host and uploads
    the rank's block of each epoch's order, the one-device cache's
    order. The caller says which rows ``data`` holds:

    - ``local=False``: the GLOBAL epoch (every rank passes the same
      arrays);
    - ``local=True``: this rank's rows, its share of every batch in
      order (``steps * local_batch`` rows; the reference's multi-process
      contract). The data blocks' rows are gathered once, at
      construction (``sharding.gather_local_rows``, one host all-gather
      over the data axes), into the global epoch in the reference's
      block-cyclic order, and the cache goes on as in the global form:
      its batches are bit-equal to a one-rank cache over that epoch.
      Host memory: the global epoch, ``data``'s bytes times the data
      blocks, on every rank for the cache's life when shuffled (an
      unshuffled cache drops it after its one upload).
    """

    def __init__(self, data: Dict[str, np.ndarray], batch_size: int,
                 mesh=None, seq_axis: Optional[str] = None,
                 shuffle: bool = False, seed: int = 0, device=None,
                 local: bool = False):
        if seq_axis is not None and mesh is None:
            raise ValueError("a sequence-split epoch needs a mesh")
        if local and mesh is None:
            raise ValueError("a local-rows epoch needs a mesh")
        self.mesh, self.seq_axis = mesh, seq_axis
        self.device = _device(device)
        self.batch_size = int(batch_size)
        self.local_batch = (self.batch_size if mesh is None else
                            sharding.local_batch_rows(mesh, self.batch_size))
        if local:
            data = sharding.gather_local_rows(mesh, data, self.local_batch)
        n = next(iter(data.values())).shape[0]
        self.steps_per_epoch = n // self.batch_size
        if self.steps_per_epoch < 1:
            raise ValueError(f"epoch of {n} rows is smaller than the batch "
                             f"{self.batch_size}")
        self.shuffle = shuffle
        self.seed = seed
        self._epoch: Optional[int] = None
        keep = self.steps_per_epoch * self.batch_size
        if keep < n:
            warnings.warn(
                f"DeviceEpochCache drops {n - keep} of {n} rows beyond "
                f"steps*batch_size ({self.steps_per_epoch}*{self.batch_size})"
                "; pad-and-mask the tail first (learners._pad_xyw) to train "
                "on every row", stacklevel=2)
        shape = (self.steps_per_epoch, self.batch_size)
        host = {k: np.asarray(v)[:keep].reshape(shape + np.asarray(v).shape[1:])
                for k, v in data.items()}
        if mesh is not None:
            # each rank uploads only its block of every batch; a shuffled
            # epoch keeps the global rows on the host and uploads the
            # rank's block of each epoch's order
            self._host = host if shuffle else None
            self._base = None
            self._batches = None if shuffle else self._split(
                self._upload(host))
            self._nbytes = sum(self._local(v).nbytes for v in host.values())
            return
        self._base = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            self.device) for k, v in host.items()}
        self._nbytes = sum(t.numel() * t.element_size()
                           for t in self._base.values())
        self._batches = None if shuffle else self._split(self._base)

    def _local(self, x: np.ndarray) -> np.ndarray:
        """This rank's block of a (steps, batch, ...) host epoch: its rows
        of every batch, and for arrays of rank > 2 its slice of the third
        dim (the sequence) under ``seq_axis``."""
        x = sharding.local_rows(self.mesh, x, axis=1)
        if x.ndim > 2:
            x = sharding.local_seq(self.mesh, x, self.seq_axis, axis=2)
        return np.ascontiguousarray(x)

    def _upload(self, host: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: to_device(self._local(v), self.device)
                for k, v in host.items()}

    @property
    def nbytes(self) -> int:
        return self._nbytes

    @staticmethod
    def fits(data: Dict[str, np.ndarray], budget_mb: Optional[float] = None,
             shuffle: bool = False) -> bool:
        """Would this host epoch fit ``runtime.device_cache_mb``? ``data``
        may hold shape/dtype stand-ins (``np.broadcast_to`` views), so
        callers budget without materializing. Charged as the reference
        does: 3x shuffled (base, permuted copy, batches), 2x unshuffled."""
        if budget_mb is None:
            budget_mb = float(mmlconfig.get("runtime.device_cache_mb"))
        total = sum(np.asarray(v).nbytes for v in data.values())
        return total * (3 if shuffle else 2) <= budget_mb * 1e6

    def _split(self, epoch: Dict[str, torch.Tensor]
               ) -> List[Dict[str, torch.Tensor]]:
        return [{k: v[i] for k, v in epoch.items()}
                for i in range(self.steps_per_epoch)]

    def _permutation(self, epoch: int) -> torch.Tensor:
        """The row order of ``epoch`` (host int64 tensor)."""
        gen = torch.Generator().manual_seed(_fold_in(self.seed, epoch))
        return torch.randperm(self.steps_per_epoch * self.batch_size,
                              generator=gen)

    def batches(self, epoch: int = 0):
        """Device batch dicts for one epoch (shuffled iff ``shuffle``)."""
        if self.shuffle and self._epoch != epoch and self.mesh is not None:
            perm = self._permutation(epoch).numpy()  # lint: allow-sync (a host permutation)
            m = perm.size
            self._batches = self._split(self._upload({
                k: v.reshape((m,) + v.shape[2:])[perm].reshape(v.shape)
                for k, v in self._host.items()}))
            self._epoch = epoch
        if self.shuffle and self._epoch != epoch:
            perm = self._permutation(epoch).to(self.device, non_blocking=True)
            m = perm.numel()
            permuted = {
                k: v.reshape((m,) + v.shape[2:]).index_select(0, perm)
                .reshape(v.shape) for k, v in self._base.items()}
            self._batches = self._split(permuted)
            self._epoch = epoch
        yield from self._batches


class DistributedTrainer:
    """Train steps of ``loss_fn`` on one device, or on each rank of a
    mesh; see the module docstring for the state and loss contracts.

    ``mesh`` defaults to the launcher's (``mesh.mesh_from_config``) once
    a process group is joined, else None: one device, ``runtime.device``.
    ``rules`` are the sharding rules (``sharding.DEFAULT_RULES`` when
    None); ``seq_axis`` names the axis the batch's second dim (the
    sequence) is split over."""

    def __init__(self, loss_fn: LossFn, optimizer, mesh=None, rules=None,
                 accum_steps: int = 1, seq_axis: Optional[str] = None,
                 remat: bool = False, device=None):
        if mesh is None and meshlib.is_initialized():
            mesh = meshlib.mesh_from_config()
        if seq_axis is not None and mesh is None:
            raise ValueError(f"seq_axis={seq_axis!r} splits the sequence "
                             "over a mesh axis: pass a mesh")
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.device = _device(device)
        self.mesh, self.rules, self.seq_axis = mesh, rules, seq_axis
        self.layout = (None if mesh is None
                       else sharding.MeshLayout(mesh, seq_axis))
        self.accum_steps = int(accum_steps)
        self.remat = remat
        self._ring: Optional[Dict[str, torch.Tensor]] = None
        self._flush_steps: Optional[int] = None
        self._steps_since_flush = 0
        self._flops_per_step: Optional[float] = None
        self._gens: Dict[int, torch.Generator] = {}
        self.last_flush: Optional[Dict[str, np.ndarray]] = None
        self._shardings: Optional[Dict[str, sharding.ParamSharding]] = None
        self._gathers: List[tuple] = []
        self._reduce: List[Tuple[Any, List[torch.nn.Parameter]]] = []

    # -- state -------------------------------------------------------------
    def init(self, init_fn: Callable[[], torch.nn.Module]) -> Dict[str, Any]:
        """``init_fn()`` returns the module with its initial parameters
        (float32 master weights); it is moved to the device (channels-last
        on a card, the layout the convs run in) and the optimizer is built
        over its parameters. On a mesh only this rank's shard of each
        parameter reaches the device."""
        module = init_fn()
        if not isinstance(module, torch.nn.Module):
            raise TypeError("init_fn must return an nn.Module, got "
                            f"{type(module).__name__}")
        if self.layout is not None:
            self._place(module)
        module = module.to(self.device).train()
        if self.device.type == "cuda":
            module = module.to(memory_format=torch.channels_last)
        state = {"module": module,
                 "optimizer": self.optimizer.init(module.parameters()),
                 "step": torch.zeros((), dtype=torch.int32,
                                     device=self.device),
                 "generators": self._gens}
        if self.layout is not None:
            state["layout"] = self.layout
        return state

    def abstract_state(self, init_fn: Callable[[], torch.nn.Module]
                       ) -> Tuple[Dict[str, Any], Optional[Dict[str, Any]]]:
        """(abstract state, shardings) of the train state without
        allocating it: ``init_fn()`` builds the module on the meta device,
        and one optimizer step on zero meta gradients creates the state
        the optimizer keeps (torch builds it at the first step).

        - abstract: ``{"params": {name: tensor}, "opt_state": {name:
          {key: tensor}}, "step": tensor}``, every tensor on the meta
          device with the global shape and dtype;
        - shardings, None without a mesh: under ``"params"`` each
          parameter's ``ParamSharding`` from the sharding rules, the
          layout :meth:`init` places each rank's shard by (it also becomes
          this trainer's :meth:`state_sharding_spec`); under
          ``"opt_state"`` each state tensor's, as
          ``optim.state_sharding`` gives it (None: replicated); ``"step"``
          None."""
        with torch.device("meta"), warnings.catch_warnings():
            # an init_fn that loads a state dict copies nothing into meta
            # parameters, and torch warns once a parameter
            warnings.filterwarnings("ignore", "for .*: copying from a "
                                    "non-meta parameter")
            module = init_fn()
        params = dict(module.named_parameters())
        opt = self.optimizer.init(params.values())
        for p in params.values():
            p.grad = torch.zeros_like(p)
        opt.torch.step()
        by_param = {id(p): n for n, p in params.items()}
        opt_state = {by_param[id(p)]: {
            k: torch.empty_like(v, device="meta")
            for k, v in opt.torch.state[p].items() if torch.is_tensor(v)}
            for p in params.values()}
        abstract = {"params": {n: p.detach() for n, p in params.items()},
                    "opt_state": opt_state,
                    "step": torch.empty((), dtype=torch.int32,
                                        device="meta")}
        if self.mesh is None:
            return abstract, None
        from mmlspark_tpu_torch.parallel.optim import state_sharding
        shardings = sharding.param_shardings(module, self.mesh, self.rules)
        self._shardings = shardings
        for n, p in params.items():
            p._mesh_sharding = shardings[n]
        return abstract, {
            "params": dict(shardings),
            "opt_state": {n: {k: state_sharding(params[n], k, v.shape,
                                                whole=True)
                              for k, v in st.items()}
                          for n, st in opt_state.items()},
            "step": None}

    def state_sharding_spec(self) -> Optional[Dict[str, Any]]:
        """``{name: ParamSharding}`` of the module's parameters on the
        mesh (None before :meth:`init`, or without a mesh)."""
        return self._shardings

    def _place(self, module: torch.nn.Module) -> None:
        """Put each parameter's shard on the device, bind the modules that
        compute on shards, and plan the gathers and gradient sums."""
        layout = self.layout
        shardings = sharding.param_shardings(module, self.mesh, self.rules)
        self._shardings = shardings
        params = dict(module.named_parameters())
        for name, p in params.items():
            sh = shardings[name]
            local = p.data[sh.slices(layout.coord)] if sh.sharded else p.data
            p.data = local.contiguous().to(self.device)
            p._mesh_sharding = sh
            p._mesh_layout = layout
            p._mesh_group = layout.group(*sh.axes) if sh.sharded else None
        claimed, summed = sharding.bind_shards(module, shardings, layout)
        self._gathers = sharding.gather_plan(module, shardings, claimed)
        # the gradient sums: over the data ranks that saw other rows and
        # hold the same part of the leaf (none for a leaf whose module
        # summed it itself); every gradient is then divided by their count
        plan: Dict[Tuple[str, ...], List[torch.nn.Parameter]] = {}
        for name, p in params.items():
            axes = () if name in summed else tuple(
                a for a in layout.grad_axes if a not in shardings[name].axes)
            plan.setdefault(axes, []).append(p)
        self._reduce = [(layout.group(*axes), ps)
                        for axes, ps in plan.items()]

    @contextlib.contextmanager
    def mesh_context(self):
        """Run code on the state's module as the step does (evaluation,
        validation sums): on a mesh the layout is :func:`sharding.current`
        and split parameters a module uses whole are gathered; nothing
        without a mesh."""
        if self.layout is None:
            yield
            return
        with sharding.activate(self.layout), self._gathered():
            yield

    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks that hold other rows (identity
        without a mesh): per-rank sums of a batch -> the global batch's."""
        if self.layout is None:
            return x
        return collectives.all_reduce(
            x, self.layout.group(*self.layout.grad_axes))

    @contextlib.contextmanager
    def _gathered(self):
        """Swap each split parameter that a module uses whole for its
        gather (differentiable: its gradient lands on the shard) while
        the step's forward and backward run."""
        layout = self.layout
        swapped = []
        try:
            for owner, attr, p, ops, kept in self._gathers:
                full = p
                for d, axes in ops:
                    full = collectives.gather_from(
                        full, d, layout.group(*axes),
                        sum_grads=any(a in layout.grad_axes for a in axes))
                if kept is not None:
                    # still a shard over the axes its module computes on
                    full._mesh_sharding = kept
                del owner._parameters[attr]
                swapped.append((owner, attr, p))
                setattr(owner, attr, full)
            yield
        finally:
            for owner, attr, p in reversed(swapped):
                delattr(owner, attr)
                owner._parameters[attr] = p

    def _sum_grads(self, module: torch.nn.Module) -> int:
        """Sum each gradient over the ranks that saw other data (one
        flat buffer per group and dtype) and divide by their count: the
        gradient of the global mean loss. Returns the bytes all-reduced."""
        n = self.layout.n_grad
        nbytes = 0
        for group, params in self._reduce:
            by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
            for p in params:
                if p.grad is not None:
                    by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
            for grads in by_dtype.values():
                if collectives.size(group) > 1:
                    flat = torch.cat([g.reshape(-1) for g in grads])
                    nbytes += flat.numel() * flat.element_size()
                    flat = collectives.all_reduce(flat, group)
                    offset = 0
                    for g in grads:
                        g.copy_(flat[offset:offset + g.numel()].view_as(g))
                        offset += g.numel()
                if n > 1:
                    torch._foreach_div_(grads, float(n))
        return nbytes

    # -- steps -------------------------------------------------------------
    def flush_steps(self) -> int:
        """Steps between ring reads (``train.metrics_flush_steps``, read
        once: it is the ring's length)."""
        if self._flush_steps is None:
            self._flush_steps = max(
                1, int(mmlconfig.get("train.metrics_flush_steps")))
        return self._flush_steps

    @property
    def flops_per_step(self) -> Optional[float]:
        """FLOPs of one train step, counted on the first step; None
        before it."""
        return self._flops_per_step

    def _generator(self, rng) -> torch.Generator:
        if isinstance(rng, torch.Generator):
            return rng
        seed = 0 if rng is None else int(rng)
        gen = self._gens.get(seed)
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self._gens[seed] = gen
        return gen

    def _loss(self, module, batch, gen) -> torch.Tensor:
        if self.remat:
            from torch.utils.checkpoint import checkpoint
            return checkpoint(self.loss_fn, module, batch, gen,
                              use_reentrant=False)
        return self.loss_fn(module, batch, gen)

    def _forward_backward(self, module, batch, gen) -> torch.Tensor:
        """The step's loss (a device scalar) with the gradients in
        ``.grad``; on a mesh the global mean of both."""
        if self.layout is None:
            return self._local_forward_backward(module, batch, gen)
        with self.mesh_context():
            loss = self._local_forward_backward(module, batch, gen)
        with span("train", "allreduce", hot=True) as reduce:
            reduce.set(bytes=self._sum_grads(module))
            return self._global_mean(loss)

    def _global_mean(self, loss: torch.Tensor) -> torch.Tensor:
        layout = self.layout
        total = collectives.all_reduce(loss, layout.group(*layout.grad_axes))
        return total / layout.n_grad if layout.n_grad > 1 else total

    def _local_forward_backward(self, module, batch, gen) -> torch.Tensor:
        accum = self.accum_steps
        if accum == 1:
            with span("train", "forward", hot=True):
                loss = self._loss(module, batch, gen)
            with span("train", "backward", hot=True):
                loss.backward()
            return loss.detach()
        micro = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
                 for k, v in batch.items()}
        total = None
        for i in range(accum):
            with span("train", "forward", hot=True):
                loss = self._loss(module,
                                  {k: v[i] for k, v in micro.items()}, gen)
            with span("train", "backward", hot=True):
                loss.backward()       # gradients sum into .grad
            total = loss.detach() if total is None else total + loss.detach()
        for p in module.parameters():
            if p.grad is not None:
                p.grad.div_(accum)
        return total / accum

    def train_step(self, state: Dict[str, Any], batch: Dict[str, torch.Tensor],
                   rng=None) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        """One step: forward, backward, optimizer update, ring write. Runs
        asynchronously on a card; returns ``(state, {"loss": device
        scalar})``. One hot ``train:step`` span over ``train:forward``,
        ``train:backward``, ``train:allreduce`` (on a mesh),
        ``train:update``, ``train:ring`` and, every ``flush_steps``,
        ``train:flush``: host spans over asynchronous launches, which
        time the host's enqueue and name the device's gaps."""
        with span("train", "step", hot=True):
            return self._train_step(state, batch, rng)

    def _train_step(self, state, batch, rng):
        fault_site("trainer.train_step")
        module, opt = state["module"], state["optimizer"]
        gen = self._generator(rng)
        flush = self.flush_steps()
        if self._ring is None:
            self._ring = {
                "loss": torch.zeros(flush, dtype=torch.float32,
                                    device=self.device),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=self.device)}
        if self._flops_per_step is None:
            from torch.utils.flop_counter import FlopCounterMode
            counter = FlopCounterMode(display=False)
            with counter:
                loss = self._forward_backward(module, batch, gen)
            self._flops_per_step = float(counter.get_total_flops())
        else:
            loss = self._forward_backward(module, batch, gen)
        with span("train", "update", hot=True):
            opt.step()
            opt.zero_grad()
        with span("train", "ring", hot=True):
            # the ring slot is computed on the device: no host read
            slot = torch.remainder(state["step"], flush).long().view(1)
            self._ring["loss"].index_copy_(0, slot, loss.float().view(1))
            state["step"].add_(1)
            self._ring["step"].copy_(state["step"])
        self._steps_since_flush += 1
        if self._steps_since_flush >= flush:
            self.flush_metrics()
        return state, {"loss": loss}

    def flush_metrics(self) -> Optional[Dict[str, np.ndarray]]:
        """Read the device metrics ring: ONE counted host sync
        (``trainer.flush``). Returns ``{"loss": (flush_steps,) float32,
        "step": int32}`` (also kept as ``last_flush``), or None before the
        first step."""
        if self._ring is None:
            return None
        with span("train", "flush", hot=True):
            self.last_flush = obssyncs.device_get(self._ring,
                                                  "trainer.flush")
        self._steps_since_flush = 0
        return self.last_flush

    def eval_step(self, state: Dict[str, Any], batch: Dict[str, torch.Tensor],
                  rng=None) -> torch.Tensor:
        """The loss without gradients (a device scalar; on a mesh the
        global mean)."""
        with torch.no_grad():
            if self.layout is None:
                return self.loss_fn(state["module"], batch,
                                    self._generator(rng))
            with self.mesh_context():
                loss = self.loss_fn(state["module"], batch,
                                    self._generator(rng))
            return self._global_mean(loss)

    # -- data --------------------------------------------------------------
    def put_batch(self, batch: Dict[str, np.ndarray], local: bool = False
                  ) -> Dict[str, torch.Tensor]:
        """A host batch on the device. On a mesh, ``batch`` is the GLOBAL
        batch, of which this rank uploads its block, or with ``local``
        this rank's own rows of the global batch
        (``sharding.shard_batch``'s two forms)."""
        if self.mesh is not None:
            return sharding.shard_batch(self.mesh, batch, self.seq_axis,
                                        self.device, local=local)
        return {k: to_device(v, self.device) for k, v in batch.items()}

    # -- telemetry ---------------------------------------------------------
    def _finish_epoch_telemetry(self, steps: int, rows: int,
                                wall_s: float) -> None:
        """End-of-epoch gauges and the ``train.fit`` event: examples/s,
        achieved TFLOP/s and, on a card, MFU against the H100 SXM data
        sheet's dense bf16 peak."""
        eps = rows / max(wall_s, 1e-9)
        obsmetrics.gauge("trainer.examples_per_sec").set(eps)
        mfu = None
        if self._flops_per_step:
            achieved = self._flops_per_step * steps / max(wall_s, 1e-9) / 1e12
            obsmetrics.gauge("trainer.achieved_tflops").set(achieved)
            if self.device.type == "cuda":
                mfu = achieved * 1e12 / obsmetrics.H100_SXM_BF16_DENSE_FLOPS
                obsmetrics.gauge("trainer.mfu").set(mfu)
        if obsevents.events_enabled():
            fields = dict(steps=steps, rows=rows, wall_s=round(wall_s, 6),
                          examples_per_sec=round(eps, 3))
            if mfu is not None:
                fields["mfu"] = round(mfu, 4)
            obsevents.emit("event", "train.fit", **fields)

    def fit(self, state: Dict[str, Any],
            batches: Iterable[Dict[str, np.ndarray]], rng=None,
            log_every: int = 0, log_fn: Callable[[int, float], None] = None,
            prefetch: Optional[int] = None,
            collect_losses: bool = True) -> Tuple[Dict[str, Any], list]:
        """Drive an epoch of host batches through the step.

        ``batches`` is any iterable of host-batch dicts — a list, a
        generator, or a streaming ``mmlspark_tpu_torch.data.Dataset`` (its
        iterator is built here and closed on exit; pass the Dataset
        itself, not ``.iter()``, unless the caller owns mid-epoch state).

        A :class:`DevicePrefetcher` assembles host batches ahead of the
        loop and each :meth:`put_batch` copies without blocking, so the
        copy overlaps the running step. ``log_every`` > 0 logs through a
        :class:`MetricLogger` (or calls ``log_fn(step, loss)``), each a
        counted sync. Returns ``(state, per-step losses)``, the losses
        fetched in one transfer at the end (an empty list with
        ``collect_losses=False``)."""
        if isinstance(batches, Dataset):
            batches = batches.iter()
        losses: List[torch.Tensor] = []
        metric_log = (MetricLogger(every=log_every)
                      if log_every and log_fn is None else None)
        # telemetry is decided once per fit: with it off the loop pays one
        # falsy check per step
        telemetry = obsmetrics.metrics_enabled() or obsevents.events_enabled()
        steps = rows_total = 0
        if telemetry:
            step_hist = obsmetrics.histogram("trainer.step_time_seconds")
            t_start = t_prev = obsevents.perf()
            sync_t0 = obssyncs.total()
            flush_t0 = obsmetrics.counter(
                "observability.sync_points.trainer.flush").value
        prefetcher = DevicePrefetcher(batches, self.put_batch, depth=prefetch)
        hb = _watchdog.register("trainer.fit")
        try:
            for i, batch in enumerate(prefetcher):
                hb.beat()
                rows = next(iter(batch.values())).shape[0] if batch else 0
                state, metrics = self.train_step(state, batch, rng)
                losses.append(metrics["loss"])
                if telemetry:
                    # dispatch-to-dispatch wall time: the loop's sustained
                    # rate, read without waiting on the device
                    now = obsevents.perf()
                    step_hist.observe(now - t_prev)
                    t_prev = now
                    steps += 1
                    rows_total += rows
                if log_fn is not None and log_every and i % log_every == 0:
                    log_fn(i, float(obssyncs.device_get(losses[-1],
                                                        "train.log")))
                elif metric_log is not None:
                    metric_log(i, {"loss": losses[-1]}, batch_rows=rows)
        finally:
            hb.close()
            prefetcher.close()
            closer = getattr(batches, "close", None)
            if callable(closer):  # pipeline iterators own decode pools
                closer()
        if telemetry and steps:
            # steady-state syncs per step, net of the ring reads (amortized
            # bookkeeping, not per-step stalls), sampled before the
            # epoch-end wait below
            flush_delta = (obsmetrics.counter(
                "observability.sync_points.trainer.flush").value - flush_t0)
            obsmetrics.gauge("train.sync_points_per_step").set(
                max(0.0, obssyncs.total() - sync_t0 - flush_delta) / steps)
            obssyncs.block_until_ready(losses[-1], "trainer.epoch_telemetry")
            self._finish_epoch_telemetry(steps, rows_total,
                                         obsevents.perf() - t_start)
        if not losses:
            return state, []
        if not collect_losses:
            obssyncs.block_until_ready(losses[-1], "trainer.fit_exit")
            return state, []
        host = obssyncs.device_get(torch.stack(losses),
                                   "trainer.collect_losses")
        return state, [float(v) for v in host]
