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
:func:`from_last`         broadcast from the last     the cotangent kept on
                          rank                        the last rank only
========================  ==========================  ====================

:func:`stage_shift` is the pipeline's hop (no autograd: the schedule in
``parallel/pipeline_parallel.py`` runs its transpose itself): rank r sends
to r + k and receives from r - k, with no wrap-around, so the first k
ranks receive zeros; ``k = -1`` is the transpose of ``k = 1``.

A group of one rank costs nothing: every op returns its input.

**Transport.** NCCL takes CUDA tensors on the card's streams and never
blocks the host. gloo runs on the host; some of its collectives take CUDA
tensors (copying through the host inside gloo), others do not
(:data:`GLOO_CUDA_DIRECT` lists the ones that do, as the card's torch
gives them). For the rest this module copies through the host itself and
counts each copy in :func:`host_copies` (``transport_host_copies``), apart
from the counted syncs of ``observability/syncs.py``: such a copy waits
for the card, and is the price of ranks that share one card over gloo.
:func:`traffic` counts every collective's calls and payload bytes by op
(what a check reads to hold, say, that no dense table gradient was
all-reduced).
"""
from __future__ import annotations

import threading

import torch

from mmlspark_tpu_torch.observability import metrics as obsmetrics

# gloo collectives that take CUDA tensors themselves (torch 2.11 on the
# card's machine, probed there; its send/recv fails with "writev ... Bad
# address"); the others copy through the host here
GLOO_CUDA_DIRECT = frozenset({"all_reduce", "all_gather", "all_to_all",
                              "broadcast"})

_lock = threading.Lock()
_host_copies = 0
_traffic: dict = {}


def traffic() -> dict:
    """``{op: {"calls": n, "bytes": b}}`` of the collectives run over
    groups of more than one rank (bytes: this rank's payload), since the
    process started or the last :func:`reset_traffic`."""
    with _lock:
        return {op: dict(v) for op, v in _traffic.items()}


def reset_traffic() -> None:
    with _lock:
        _traffic.clear()


def _sent(op: str, x: torch.Tensor) -> None:
    with _lock:
        entry = _traffic.setdefault(op, {"calls": 0, "bytes": 0})
        entry["calls"] += 1
        entry["bytes"] += x.numel() * x.element_size()


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

def host_all_gather(x, group) -> list:
    """Every rank's host value ``x`` (a numpy array, or anything that
    pickles) in ``group``, in group-rank order: the host-side exchange of
    a meshed fit's inputs (moments, verdicts, step counts, the local-rows
    epoch cache's rows). ``dist.all_gather_object``, so it runs on gloo
    and on NCCL alike (there the pickled bytes travel as a tensor on this
    rank's card). ``group`` None (one rank) returns ``[x]``."""
    if group is None:
        return [x]
    out = [None] * size(group)
    _dist().all_gather_object(out, x, group=group)
    return out


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The reduction of ``x`` over ``group`` ("sum" or "max"), as a new
    tensor (``x`` is left as it is)."""
    if size(group) == 1:
        return x
    dist = _dist()
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    _sent("all_reduce", x)
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
    _sent("all_gather", x)
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
    _sent("all_to_all", x)
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
    _sent("ring_shift", x)
    host = _via_host("ring_shift", group, x)
    src = _to_host(x) if host else x.detach().contiguous()
    y = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, to, group),
           dist.P2POp(dist.irecv, y, frm, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return _back(y, x) if host else y


def stage_shift(x: torch.Tensor, group, offset: int = 1) -> torch.Tensor:
    """The ``x`` of group rank ``rank - offset``, or zeros where there is
    none; this rank's ``x`` goes to ``rank + offset`` when that rank
    exists (``jax.lax.ppermute`` with ``perm=[(j, j + offset)]`` for the
    j that stay in the group). Every rank of the group must call it."""
    n = size(group)
    dist = _dist()
    me = rank(group)
    dst, src = me + offset, me - offset
    host = _via_host("stage_shift", group, x)
    if 0 <= dst < n:
        _sent("stage_shift", x)
    ops = []
    if 0 <= dst < n:
        buf = _to_host(x) if host else x.detach().contiguous()
        ops.append(dist.P2POp(dist.isend, buf,
                              dist.get_global_rank(group, dst), group))
    y = torch.zeros(x.shape, dtype=x.dtype,
                    device="cpu" if host else x.device)
    if 0 <= src < n:
        ops.append(dist.P2POp(dist.irecv, y,
                              dist.get_global_rank(group, src), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if host:
        return _back(y, x) if 0 <= src < n else y.to(x.device)
    return y


def broadcast(x: torch.Tensor, group, src: int) -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank of the group (a new
    tensor)."""
    if size(group) == 1:
        return x
    dist = _dist()
    _sent("broadcast", x)
    host = _via_host("broadcast", group, x)
    y = _to_host(x) if host else x.detach().clone()
    dist.broadcast(y, src=dist.get_global_rank(group, src), group=group)
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


class _FromLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return broadcast(x, group, size(group) - 1)

    @staticmethod
    def backward(ctx, g):
        last = rank(ctx.group) == size(ctx.group) - 1
        return (g if last else torch.zeros_like(g)), None


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


def from_last(x: torch.Tensor, group) -> torch.Tensor:
    """The last group rank's ``x`` on every rank (the reference's psum of
    a tensor masked to the last pipeline stage). Every rank then computes
    the same loss from it, so each holds the same cotangent: the backward
    hands it to the last rank ONCE and zeros to the others."""
    return x if size(group) == 1 else _FromLast.apply(x, group)
