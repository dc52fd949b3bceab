"""Pipeline parallelism over the ``pipe`` mesh axis.

The port of ``mmlspark_tpu/parallel/pipeline_parallel.py``: the GPipe
schedule of M + S - 1 ticks. There one ``lax.scan`` inside a
``shard_map`` moved activations rank to rank with ``ppermute`` and JAX
differentiated through it; here each pipe rank runs the ticks eagerly,
and the hop between stages is :func:`collectives.stage_shift`.

- Every pipe rank holds its contiguous block of the stacked stages
  (``n_stages / |pipe|`` of them: virtual stages, so an 8-stage stack on
  a 2-rank pipe computes stages [0..3] -> [4..7]) and chains them each
  tick on what it received; rank 0 feeds microbatch ``t`` at tick ``t``.
  A rank whose microbatch index lies outside [0, M) at a tick skips the
  stages (the reference computed them and masked the result to zero) but
  still takes part in the hop.
- The schedule is one autograd node (:class:`_Schedule`): its forward
  keeps each tick's graph of the stages, its backward walks the ticks in
  reverse, each with the transpose of the tick's hop (the reverse shift)
  and then the tick's stages. Every rank issues the same hops in the same
  order, in the forward and in the backward, so no rank waits on a
  partner that is elsewhere.
- The outputs live on the last rank: :func:`collectives.from_last`
  broadcasts them (the reference's masked psum) and hands the replicated
  cotangent back to the last rank once. The input enters through
  :func:`collectives.copy_to`, so a replicated upstream layer's gradient
  (summed over ``pipe``) is complete on every rank, as the reference's
  shard_map transpose gives it.

Constraints, as the reference's: every stage maps activations to the SAME
shape and dtype (embed and head layers stay outside the pipelined region);
this rank's batch (its block over the data axes: the port's steps see
their rank's rows) divides into ``n_microbatches``. The bubble is
(S - 1)/(M + S - 1) of a step.

:class:`StageStack` is a stacked stage tree as a module, so that
``DistributedTrainer`` places its leaves with
``sharding.pipeline_stacked_rules`` (the stage dim over ``pipe``) and
keeps them split: each rank holds its stages only.
"""
from __future__ import annotations

import contextlib
from collections.abc import Mapping
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
from torch import nn

from mmlspark_tpu_torch.parallel import collectives
from mmlspark_tpu_torch.parallel.mesh import mesh_shape
from mmlspark_tpu_torch.parallel.sharding import axis_group


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, Mapping):
        out = []
        for k, v in tree.items():
            out += _flatten(v, f"{prefix}{k}.")
        return out
    return [(prefix[:-1], tree)]


def _unflatten(pairs) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, leaf in pairs:
        node = out
        *path, last = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def _map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def stack_stage_params(params_list: Sequence[Any]) -> Dict[str, Any]:
    """Per-stage param trees (nested dicts of tensors) -> one tree with a
    leading stage dim."""
    flat = [dict(_flatten(p)) for p in params_list]
    return _unflatten((k, torch.stack([f[k] for f in flat]))
                      for k in flat[0])


def init_stage_params(stage_init: Callable[[torch.Generator, int], Any],
                      n_stages: int, gen: torch.Generator) -> Dict[str, Any]:
    """Initialize S stages with distinct generators; returns the stacked
    tree. ``stage_init(generator, stage_index) -> params`` for one stage;
    stage i's generator is seeded from the i-th of ``n_stages`` seeds
    drawn from ``gen`` (the reference split its key in ``n_stages``)."""
    seeds = torch.randint(0, 2 ** 62, (n_stages,), generator=gen)
    return stack_stage_params(
        [stage_init(torch.Generator().manual_seed(int(seeds[i])), i)
         for i in range(n_stages)])


def pipeline_spec(mesh=None, pipe_axis: str = "pipe") -> Tuple[str, ...]:
    """The spec of a stacked stage leaf: the stage dim over ``pipe``."""
    return (pipe_axis,)


def _pipe_split(leaf, pipe_axis: str) -> bool:
    sh = getattr(leaf, "_mesh_sharding", None)
    return sh is not None and sh.dim_of(pipe_axis) == 0


def _stages_of(leaf, pipe_axis: str) -> int:
    """The stack's stage count: a leaf placed split over ``pipe`` holds a
    block of it (its placement knows the whole shape)."""
    if _pipe_split(leaf, pipe_axis):
        return leaf._mesh_sharding.shape[0]
    return leaf.shape[0]


def _chain(stage_fn, params: Dict[str, Any], x: torch.Tensor,
           n: int) -> torch.Tensor:
    """``n`` stages of a stacked tree, in order, on ``x``."""
    for i in range(n):
        x = stage_fn(_map(lambda a: a[i], params), x)
    return x


class _Schedule(torch.autograd.Function):
    """The GPipe ticks of this rank (see the module docstring); returns
    the outputs banked on the last rank (zeros on the others)."""

    @staticmethod
    def forward(ctx, stage_fn, group, M, k_local, names, grad, x, *leaves):
        S, idx = collectives.size(group), collectives.rank(group)
        xs = x.reshape((M, x.shape[0] // M) + x.shape[1:])
        # the stages' graphs hang off detached twins of the inputs
        twins = [t.detach().requires_grad_(grad and t.requires_grad)
                 for t in leaves]
        params = _unflatten(zip(names, twins))
        acc = torch.zeros_like(xs)
        recv = torch.zeros_like(xs[0])
        graphs: Dict[int, tuple] = {}
        ticks = M + S - 1
        for t in range(ticks):
            mb = t - idx
            out = torch.zeros_like(xs[0])
            if 0 <= mb < M:
                inp = (xs[mb] if idx == 0 else recv).detach()
                inp.requires_grad_(grad)
                with torch.enable_grad() if grad else contextlib.nullcontext():
                    out = _chain(stage_fn, params, inp, k_local)
                if out.shape != inp.shape or out.dtype != inp.dtype:
                    raise ValueError(
                        f"a pipelined stage maps {tuple(inp.shape)} "
                        f"{inp.dtype} to {tuple(out.shape)} {out.dtype}: "
                        "every stage must keep the shape and dtype")
                if grad:
                    graphs[t] = (inp, out)
                out = out.detach()
                if idx == S - 1:
                    acc[mb] = out
            if t < ticks - 1:
                recv = collectives.stage_shift(out, group, 1)
        ctx.stage = (group, M, idx, twins, graphs, xs.shape,
                     x.requires_grad)
        return acc.reshape(x.shape)

    @staticmethod
    def backward(ctx, g_acc):
        group, M, idx, twins, graphs, shape, want_x = ctx.stage
        S = collectives.size(group)
        g_acc = g_acc.reshape(shape)
        g_leaves = [torch.zeros_like(t) for t in twins]
        g_x = torch.zeros(shape, dtype=g_acc.dtype, device=g_acc.device)
        ticks = M + S - 1
        g_recv = torch.zeros_like(g_acc[0])
        for t in reversed(range(ticks)):
            g_out = torch.zeros_like(g_acc[0])
            if t < ticks - 1:
                # the transpose of tick t's hop: the gradient of what this
                # rank received goes back to its sender
                g_out = collectives.stage_shift(g_recv, group, -1)
            mb = t - idx
            g_recv = torch.zeros_like(g_acc[0])
            if not 0 <= mb < M:
                continue
            if idx == S - 1:
                g_out = g_out + g_acc[mb]
            inp, out = graphs.pop(t)
            wanted = [inp] + [w for w in twins if w.requires_grad]
            grads = torch.autograd.grad(out, wanted, g_out,
                                        allow_unused=True)
            it = iter(grads[1:])
            for i, w in enumerate(twins):
                if w.requires_grad:
                    g = next(it)
                    if g is not None:
                        g_leaves[i] += g
            if grads[0] is not None:
                if idx == 0:
                    g_x[mb] = grads[0]
                else:
                    g_recv = grads[0]
        g_x = g_x.reshape((-1,) + tuple(shape[2:])) if want_x else None
        return (None, None, None, None, None, None, g_x, *g_leaves)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stacked_params: Any, x: torch.Tensor, mesh,
                   n_microbatches: int, pipe_axis: str = "pipe"
                   ) -> torch.Tensor:
    """Run ``x`` through the pipelined stages; returns the last stage's
    output on every rank.

    ``stacked_params``: a nested dict of tensors with a leading stage dim:
    the whole stack (each rank takes its block, and its gradient is
    gathered back whole), or, for leaves the trainer placed split over
    ``pipe`` (:class:`StageStack`), the rank's block. ``x``: this rank's
    rows (its block over the data axes) entering stage 0. The stage count
    may be any multiple of |pipe|. With no mesh, or |pipe| = 1, the stages
    run in sequence."""
    S = mesh_shape(mesh).get(pipe_axis, 1) if mesh is not None else 1
    pairs = _flatten(stacked_params)
    n_stages = _stages_of(pairs[0][1], pipe_axis)
    if n_stages % S:
        raise ValueError(
            f"stacked stage count {n_stages} must be a multiple of "
            f"|{pipe_axis}|={S}")
    if S == 1:
        return _chain(stage_fn, stacked_params, x, n_stages)
    M = int(n_microbatches)
    if x.shape[0] % M:
        raise ValueError(
            f"per-data-shard batch {x.shape[0]} must divide into "
            f"n_microbatches={M}")
    group = axis_group(mesh, (pipe_axis,))
    leaves = [t if _pipe_split(t, pipe_axis)
              else collectives.slice_of(t, 0, group) for _, t in pairs]
    names = [n for n, _ in pairs]
    grad = torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in leaves))
    out = _Schedule.apply(stage_fn, group, M, n_stages // S, names, grad,
                          collectives.copy_to(x, group), *leaves)
    return collectives.from_last(out, group)


class _Leaves(nn.Module):
    """A level of a :class:`StageStack`'s tree."""

    def __init__(self, tree: Mapping):
        super().__init__()
        self._leaf_names = []
        for k, v in tree.items():
            if isinstance(v, Mapping):
                self.add_module(k, _Leaves(v))
            else:
                self.register_parameter(k, nn.Parameter(torch.as_tensor(v)))
                self._leaf_names.append(k)

    def tree(self) -> Dict[str, Any]:
        """The tree of the tensors in use (a gather the trainer swapped
        in for a split parameter included)."""
        out: Dict[str, Any] = {k: getattr(self, k) for k in self._leaf_names}
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


class StageStack(_Leaves):
    """A stacked stage tree (``stack_stage_params``' output) as a module:
    its leaves are parameters named by their path (``mlp_up.weight``), so
    the rules place them (``sharding.pipeline_stacked_rules`` under the
    module's name, ``stages`` by default). Bound to a mesh it keeps its
    ``pipe`` split (each rank holds and computes its stages); other axes
    a leaf is split over are gathered for the stages by the trainer.
    ``stack(stage_fn, x, n_microbatches)`` is :func:`pipeline_apply` over
    it on the bound mesh (in sequence without one)."""

    def __init__(self, tree: Mapping, pipe_axis: str = "pipe"):
        super().__init__(tree)
        self.pipe_axis = pipe_axis
        self._mesh = None

    def bind_mesh(self, layout, shardings) -> dict:
        self._mesh = layout.mesh
        return {n: (self.pipe_axis,) for n, sh in shardings.items()
                if sh.dim_of(self.pipe_axis) == 0}

    def forward(self, stage_fn, x: torch.Tensor,
                n_microbatches: int) -> torch.Tensor:
        return pipeline_apply(stage_fn, self.tree(), x, self._mesh,
                              n_microbatches, self.pipe_axis)


__all__ = ["StageStack", "init_stage_params", "pipeline_apply",
           "pipeline_spec", "stack_stage_params"]
