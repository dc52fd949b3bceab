"""The collectives the meshed layers run, and their transposes for autograd.

Under GSPMD the JAX package never wrote a collective: XLA inserted the
psums, all-gathers and all-to-alls its shardings implied, and
differentiated ``ppermute`` and ``all_to_all`` by itself. The port writes
each one down, on ``torch.distributed`` process groups (one group a mesh
axis, or a few axes together), with the backward each needs:

========================  ==========================  ====================
op                        forward                     backward
========================  ==========================  ====================
:func:`copy_to`           identity                    all-reduce (sum)
:func:`reduce_from`       all-reduce (sum)            identity
:func:`gather_from`       all-gather along ``dim``    this rank's slice
                                                      (summed over the
                                                      group first when
                                                      the ranks saw
                                                      different data)
:func:`slice_of`          this rank's slice           all-gather
:func:`exchange`          all-to-all of dim-0 chunks  the same all-to-all
:func:`shift`             send to rank+k, receive     send to rank-k,
                          from rank-k                 receive from rank+k
========================  ==========================  ====================

A group of one rank costs nothing: every op returns its input.

**Transport.** NCCL takes CUDA tensors on the card's streams and never
blocks the host. gloo runs on the host; some of its collectives take CUDA
tensors (copying through the host inside gloo), others do not
(:data:`GLOO_CUDA_DIRECT` lists the ones that do, as the card's torch
gives them). For the rest this module copies through the host itself and
counts each copy in :func:`host_copies` (``transport_host_copies``), apart
from the counted syncs of ``observability/syncs.py``: such a copy waits
for the card, and is the price of ranks that share one card over gloo.
"""
from __future__ import annotations

import threading

import torch

from mmlspark_tpu_torch.observability import metrics as obsmetrics

# gloo collectives that take CUDA tensors themselves (torch 2.11 on the
# card's machine, probed there: these, and broadcast, do; its send/recv
# fails with "writev ... Bad address"); the others copy through the host
# here
GLOO_CUDA_DIRECT = frozenset({"all_reduce", "all_gather", "all_to_all"})

_lock = threading.Lock()
_host_copies = 0


def host_copies() -> int:
    """Device<->host copies made for gloo collectives on CUDA tensors
    (``transport_host_copies``), since the process started or the last
    :func:`reset_host_copies`."""
    return _host_copies


def reset_host_copies() -> None:
    global _host_copies
    with _lock:
        _host_copies = 0


def _count(n: int) -> None:
    global _host_copies
    with _lock:
        _host_copies += n
    obsmetrics.counter("parallel.transport_host_copies").inc(n)


def _dist():
    import torch.distributed as dist
    return dist


def size(group) -> int:
    return 1 if group is None else _dist().get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else _dist().get_rank(group)


def _via_host(op: str, group, x: torch.Tensor) -> bool:
    return (x.device.type == "cuda" and op not in GLOO_CUDA_DIRECT
            and _dist().get_backend(group) == "gloo")


def _to_host(x: torch.Tensor) -> torch.Tensor:
    _count(1)
    return x.detach().to("cpu")


def _back(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    _count(1)
    return y.to(like.device)


# -- plain collectives (no autograd) -----------------------------------------

def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The reduction of ``x`` over ``group`` ("sum" or "max"), as a new
    tensor (``x`` is left as it is)."""
    if size(group) == 1:
        return x
    dist = _dist()
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    host = _via_host("all_reduce", group, x)
    y = _to_host(x) if host else x.detach().clone()
    dist.all_reduce(y, op=red, group=group)
    return _back(y, x) if host else y


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order."""
    n = size(group)
    if n == 1:
        return x
    dist = _dist()
    host = _via_host("all_gather", group, x)
    src = _to_host(x) if host else x.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    y = torch.cat(parts, dim=dim)
    return _back(y, x) if host else y


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` of shape (S, ...) with S the group's size: chunk j goes to
    group rank j, and chunk j of the result came from group rank j."""
    n = size(group)
    if n == 1:
        return x
    if x.shape[0] != n:
        raise ValueError(f"all_to_all wants a leading dim of {n}, got "
                         f"{tuple(x.shape)}")
    host = _via_host("all_to_all", group, x)
    src = _to_host(x) if host else x.detach().contiguous()
    y = torch.empty_like(src)
    _dist().all_to_all_single(y, src, group=group)
    return _back(y, x) if host else y


def ring_shift(x: torch.Tensor, group, offset: int = 1) -> torch.Tensor:
    """The ``x`` of group rank ``rank - offset`` (this rank's ``x`` goes to
    ``rank + offset``): one step of a ring, as ``jax.lax.ppermute`` with
    ``perm=[(j, j + offset)]``."""
    n = size(group)
    if n == 1 or offset % n == 0:
        return x
    dist = _dist()
    me = rank(group)
    to = dist.get_global_rank(group, (me + offset) % n)
    frm = dist.get_global_rank(group, (me - offset) % n)
    host = _via_host("ring_shift", group, x)
    src = _to_host(x) if host else x.detach().contiguous()
    y = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, to, group),
           dist.P2POp(dist.irecv, y, frm, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return _back(y, x) if host else y


# -- autograd ----------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _my_slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = size(group)
    step = x.shape[dim] // n
    return x.narrow(dim, rank(group) * step, step).contiguous()


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, sum_grads):
        ctx.dim, ctx.group, ctx.sum_grads = dim, group, sum_grads
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grads:
            g = all_reduce(g, ctx.group)
        return _my_slice(g, ctx.dim, ctx.group), None, None, None


class _SliceOf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _my_slice(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.dim, ctx.group), None, None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g.contiguous(), ctx.group), None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, offset):
        ctx.group, ctx.offset = group, offset
        return ring_shift(x, group, offset)

    @staticmethod
    def backward(ctx, g):
        return ring_shift(g.contiguous(), ctx.group, -ctx.offset), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient summed over ``group`` (a replicated
    activation entering a layer split over the group)."""
    return x if size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` forward (partial outputs of a split layer);
    the gradient passes as it is."""
    return x if size(group) == 1 else _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, dim: int, group,
                sum_grads: bool) -> torch.Tensor:
    """Gather a shard along ``dim`` for a use that needs the whole tensor;
    the backward keeps this rank's slice of the gradient, summed over the
    group first when ``sum_grads`` (ranks that saw different data)."""
    if size(group) == 1:
        return x
    return _GatherFrom.apply(x, dim, group, sum_grads)


def slice_of(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice along ``dim`` of a tensor replicated over
    ``group``; the gradient is gathered back to the whole tensor."""
    return x if size(group) == 1 else _SliceOf.apply(x, dim, group)


def exchange(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable :func:`all_to_all` (its own transpose)."""
    return x if size(group) == 1 else _Exchange.apply(x, group)


def shift(x: torch.Tensor, group, offset: int = 1) -> torch.Tensor:
    """Differentiable :func:`ring_shift`: the backward shifts the other
    way, as ppermute's transpose does."""
    return x if size(group) == 1 else _Shift.apply(x, group, offset)

