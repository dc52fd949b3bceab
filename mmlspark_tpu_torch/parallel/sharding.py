"""Sharding rules: which dims of which parameter lie split over which axes.

The port of ``mmlspark_tpu/parallel/sharding.py``. The reference wrote
(regex, PartitionSpec) rules on flax's '/'-joined parameter paths and let
GSPMD place every leaf; the port keeps the rules and the fitting, written
on its own names and layouts:

- a leaf is named by its state-dict key, lower-cased (``block0.attn_query
  .weight``), and a spec's dims are in the torch layout
  (``models/convert.py``: a dense ``kernel`` (in, out) is ``weight`` (out,
  in), a conv kernel HWIO is OIHW, a norm ``scale`` is a 1-D ``weight``).
  So a rule for kernels matches ``.weight`` of rank >= 2 (the third entry
  of a rule is the least rank it applies to);
- an entry of a spec is None (not split), an axis name, or a tuple of axis
  names; a dim split over two axes is split in the mesh's axis order
  (DTensor's), where the reference split it in the spec's order (the
  same axes hold the same dims);
- :func:`param_shardings` returns one :class:`ParamSharding` a leaf: the
  spec, fitted to the leaf's shape and the mesh as ``_fit_spec`` does,
  and its DTensor placements (``Shard(d)`` / ``Replicate()`` per mesh
  dimension).

The trainer (``parallel/trainer.py``) stores each parameter as the shard
its rank holds; a module that can compute on its shards
(``bind_mesh``, the transformer's tensor-parallel blocks) does so, every
other use gathers the shard first. The batch helpers below give each
rank its block of a global batch: the rows of its coordinate on the data
axes and, under a ``seq`` axis, its slice of the sequence; or, in the
local-rows form the caller asks for, take the rank's own rows of each
global batch (the reference's multi-process contract,
:func:`gather_local_rows` assembling a whole epoch from them).
"""
from __future__ import annotations

import contextlib
import math
import re
import threading
from collections.abc import Mapping
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from mmlspark_tpu_torch.parallel.mesh import AXES, mesh_shape

Entry = Any                      # None | axis name | tuple of axis names
Spec = Tuple[Entry, ...]
Rules = Sequence[Tuple[str, Spec, int]]

# The reference's DEFAULT_RULES on the port's names, torch-order dims:
# - large matmul weights: output features over `tensor` where the layer is
#   split by columns (q/k/v, mlp up, heads), input features where it is
#   split by rows (attention out, mlp down); the other dim over `fsdp`;
# - embedding tables: rows (the vocabulary) over `tensor`;
# - every other weight of rank >= 2: its output features (torch dim 0)
#   over `fsdp`; biases and norm scales replicated.
DEFAULT_RULES: List[Tuple[str, Spec, int]] = [
    (r".*experts?_(up|wi|gate).*", ("expert", "fsdp", "tensor"), 0),
    (r".*experts?_(down|wo|out).*", ("expert", "tensor", "fsdp"), 0),
    (r".*router.*", (), 0),
    (r".*(attention|attn).*(query|key|value|qkv).*\.weight",
     ("tensor", "fsdp"), 2),
    # flax MultiHeadDotProductAttention's "out" (heads, head_dim, out)
    # kernel is (out, heads * head_dim) here
    (r".*(attention|attn).*\.out\.weight", (None, ("tensor", "fsdp")), 2),
    (r".*(attention|attn).*out.*\.weight", ("fsdp", "tensor"), 2),
    (r".*mlp.*(up|gate|wi|fc1|intermediate).*\.weight",
     ("tensor", "fsdp"), 2),
    (r".*mlp.*(down|wo|fc2|output).*\.weight", ("fsdp", "tensor"), 2),
    # embedding LEAVES only (the name ends in 'embedding'): a conv named
    # *_embedding keeps its spatial dims whole
    (r".*embedding$", ("tensor", None), 0),
    (r".*(head|logits|classifier).*\.weight", ("tensor", "fsdp"), 2),
    (r".*\.weight", ("fsdp",), 2),
    (r".*", (), 0),
]

# catch-alls whose specs are not stretched onto a leaf of rank > 2 under
# the default rules: such a leaf gets the spatial-safe spec instead
_GENERIC_PATTERNS = {r".*\.weight", r".*"}
BATCH_AXES = ("data", "fsdp")


def _axes(entry: Entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _conv_safe(name: str, ndim: int) -> Spec:
    """A kernel of rank > 2 never splits its spatial dims: only its output
    features over ``fsdp`` (torch dim 0 of a ``weight``, the last dim of
    a leaf kept in flax's layout)."""
    if name.endswith(".weight") or name == "weight":
        return ("fsdp",) + (None,) * (ndim - 1)
    return (None,) * (ndim - 1) + ("fsdp",)


def _fit_spec(spec: Spec, ndim: int, shape: Sequence[int],
              sizes: Dict[str, int]) -> Spec:
    """Clamp a spec to the leaf's rank and divisibility: an entry whose
    axes the mesh lacks, whose size is 1, or that does not divide the dim
    becomes None; axes of size 1 drop out of an entry. Axes are kept in
    the mesh's order."""
    entries = (list(spec) + [None] * ndim)[:ndim]
    fixed: List[Entry] = []
    for dim, entry in zip(shape, entries):
        axes = _axes(entry)
        # axes of size 1 split nothing (a dim merged from two flax dims
        # keeps the axis of the one that is split)
        live = tuple(a for a in AXES if a in axes and sizes.get(a, 1) > 1)
        size = math.prod(sizes[a] for a in live)
        if not axes or not all(a in sizes for a in axes) or not live \
                or dim % size:
            fixed.append(None)
            continue
        fixed.append(live[0] if len(live) == 1 else live)
    return tuple(fixed)


class ParamSharding:
    """One leaf's placement: ``spec`` (per torch dim), the leaf's global
    ``shape``, and the mesh's axis sizes."""

    def __init__(self, spec: Spec, shape: Sequence[int],
                 sizes: Dict[str, int]):
        self.spec = tuple(spec)
        self.shape = tuple(int(s) for s in shape)
        self.sizes = dict(sizes)

    def __repr__(self) -> str:
        return f"ParamSharding(spec={self.spec}, shape={self.shape})"

    @property
    def axes(self) -> Tuple[str, ...]:
        """Every axis some dim is split over, in mesh order."""
        used = {a for e in self.spec for a in _axes(e)}
        return tuple(a for a in AXES if a in used)

    @property
    def sharded(self) -> bool:
        return bool(self.axes)

    def keeping(self, axes: Sequence[str]) -> "ParamSharding":
        """This placement with only ``axes`` left split (the tensor a
        partial gather of the shard gives)."""
        spec = []
        for e in self.spec:
            live = tuple(a for a in _axes(e) if a in axes)
            spec.append(None if not live else
                        live[0] if len(live) == 1 else live)
        return ParamSharding(spec, self.shape, self.sizes)

    def dim_of(self, axis: str) -> Optional[int]:
        for d, e in enumerate(self.spec):
            if axis in _axes(e):
                return d
        return None

    def shard_shape(self) -> Tuple[int, ...]:
        out = list(self.shape)
        for d, e in enumerate(self.spec):
            out[d] //= math.prod(self.sizes[a] for a in _axes(e))
        return tuple(out)

    def slices(self, coord: Dict[str, int]) -> Tuple[slice, ...]:
        """The index of the shard held at mesh coordinate ``coord``."""
        out = []
        for d, e in enumerate(self.spec):
            axes = _axes(e)
            if not axes:
                out.append(slice(None))
                continue
            idx = 0
            for a in axes:              # mesh order: major to minor
                idx = idx * self.sizes[a] + coord[a]
            step = self.shape[d] // math.prod(self.sizes[a] for a in axes)
            out.append(slice(idx * step, (idx + 1) * step))
        return tuple(out)

    def placements(self) -> list:
        """DTensor placements, one a mesh dimension in :data:`AXES`."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for a in AXES:
            d = self.dim_of(a)
            out.append(Replicate() if d is None else Shard(d))
        return out


def without_dim(sh: ParamSharding, dim: int) -> ParamSharding:
    """``sh`` for a tensor that lost dim ``dim`` (a reduction over it)."""
    return ParamSharding(sh.spec[:dim] + sh.spec[dim + 1:],
                         sh.shape[:dim] + sh.shape[dim + 1:], sh.sizes)


def _leaves(params: Any):
    """(name, leaf) pairs of a module's parameters or a flat state dict."""
    if hasattr(params, "named_parameters"):
        return list(params.named_parameters())
    if isinstance(params, Mapping):
        return list(params.items())
    raise TypeError(f"want an nn.Module or a state dict, got "
                    f"{type(params).__name__}")


def param_shardings(params: Any, mesh, rules: Optional[Rules] = None
                    ) -> Dict[str, ParamSharding]:
    """``{name: ParamSharding}`` of a module's parameters (or a state
    dict) from name-pattern rules: the first rule whose pattern matches
    the lower-cased name in full, and whose least rank the leaf reaches,
    decides. ``mesh`` is a DeviceMesh or an ``{axis: size}`` dict."""
    sizes = mesh_shape(mesh)
    using_defaults = rules is None
    rules = list(DEFAULT_RULES if rules is None else rules)
    out: Dict[str, ParamSharding] = {}
    for name, leaf in _leaves(params):
        shape = tuple(getattr(leaf, "shape", ()))
        ndim = len(shape)
        key = str(name).lower()
        spec = _conv_safe(key, ndim) if ndim > 2 else ()
        for rule in rules:
            pattern, rule_spec = rule[0], rule[1]
            least = rule[2] if len(rule) > 2 else 0
            if ndim >= least and re.fullmatch(pattern, key):
                spec = rule_spec
                if ndim > 2 and using_defaults \
                        and pattern in _GENERIC_PATTERNS:
                    spec = _conv_safe(key, ndim)
                break
        out[str(name)] = ParamSharding(_fit_spec(spec, ndim, shape, sizes),
                                       shape, sizes)
    return out


def pipeline_stacked_rules(base: Optional[Rules] = None,
                           prefix: str = "stages") -> List[Tuple[str, Spec,
                                                                 int]]:
    """Rules for a state holding a STACKED pipeline-stage subtree (leaves
    under ``prefix``, e.g. ``stages.mlp_up.weight``, carry a leading stage
    dim, as ``pipeline_parallel.stack_stage_params`` builds them): every
    base rule mirrored with ``prefix`` required in the name, ``pipe``
    prepended to its spec and its least rank raised by one (the stage dim
    over ``pipe``, the other dims placed as their unstacked twins'), ahead
    of the base rules for the leaves outside the pipelined region."""
    base = list(base) if base is not None else list(DEFAULT_RULES)
    anchor = r"(?=.*" + re.escape(prefix) + r"\.)"
    staged = [(anchor + rule[0], ("pipe",) + tuple(rule[1]),
               (rule[2] + 1 if len(rule) > 2 and rule[2] else 0))
              for rule in base]
    return staged + base


def replicated(mesh=None) -> Spec:
    """The spec of a replicated leaf."""
    return ()


def tensor_axis_size(mesh) -> int:
    """Size of the model (``tensor``) axis; 1 for no mesh / axis absent."""
    return 1 if mesh is None else mesh_shape(mesh).get("tensor", 1)


def embedding_table_sharding(mesh) -> Spec:
    """Spec of an embedding table (rows, dim): rows over ``tensor`` (each
    rank holds a contiguous row range), replicated when the mesh has no
    ``tensor`` axis of more than one rank."""
    return ("tensor", None) if tensor_axis_size(mesh) > 1 else ()


def embedding_lookup_specs(mesh) -> Tuple[Spec, Spec, Spec]:
    """``(table, ids, out)`` specs of the fused lookup: table rows over
    ``tensor``; the id (and weight) block over the data axes, replicated
    over ``tensor`` (every row shard sees every id of its batch block, to
    answer for the rows it holds); the bags back over the data axes."""
    axes = active_batch_axes(mesh)
    return ("tensor", None), (axes, None), (axes, None)


def active_batch_axes(mesh, batch_axes: Sequence[str] = BATCH_AXES):
    """The non-trivial data-parallel axes of this mesh (None if all size
    1): the one definition of which axes split the batch."""
    sizes = mesh_shape(mesh)
    return tuple(a for a in batch_axes if sizes.get(a, 1) > 1) or None


def batch_sharding(mesh, batch_axes: Sequence[str] = BATCH_AXES,
                   seq_axis: Optional[str] = None) -> Spec:
    """Batch dim over the data axes; with ``seq_axis`` the second dim
    (the sequence) over it."""
    axes = active_batch_axes(mesh, batch_axes)
    if seq_axis and mesh_shape(mesh).get(seq_axis, 1) > 1:
        return (axes, seq_axis)
    return (axes,)


def epoch_cache_sharding(mesh, ndim: int,
                         seq_axis: Optional[str] = None) -> Spec:
    """Spec of a resident epoch array (steps, batch, ...): steps
    replicated, batch over the data axes, the third dim over ``seq`` for
    arrays of rank > 2 when asked."""
    axes = active_batch_axes(mesh)
    if ndim > 2 and seq_axis and mesh_shape(mesh).get(seq_axis, 1) > 1:
        return (None, axes, seq_axis)
    return (None, axes)


def mesh_spans_processes(mesh) -> bool:
    """True when the mesh holds ranks other than this one (with one rank
    a process, any mesh of more than one rank). The trainer's question;
    scoring asks :func:`mesh_spans_hosts`."""
    return mesh is not None and mesh.size() > 1


def mesh_spans_hosts(hosts: Sequence[str], ranks: Sequence[int]) -> bool:
    """True when the ranks ``ranks`` do not all run on the host of the
    first of them (``hosts[r]`` is rank r's hostname, as the ranks stated
    it when they joined). Scoring is per host: the leader's rows are
    scored by ranks of its own host, which takes the place of the
    reference's refusal of a mesh spanning processes (there one process
    drove all of its host's devices)."""
    ranks = list(ranks)
    return bool(ranks) and any(hosts[r] != hosts[ranks[0]] for r in ranks)


def kv_arena_sharding(mesh, heads: int) -> Spec:
    """Spec of a paged KV arena (layers, blocks, block_tokens, heads,
    head_dim): the head dim over ``tensor`` when that axis is more than
    one rank and divides the head count -- the split the attention
    projections use, so each rank attends over the heads it computed and
    no K/V crosses ranks. Otherwise replicated."""
    t = tensor_axis_size(mesh)
    if t > 1 and heads % t == 0:
        return (None, None, None, "tensor", None)
    return ()


def kv_scale_sharding(mesh) -> Spec:
    """Spec of the int8 arena's scale planes (layers, blocks,
    block_tokens): no head dim, so replicated (they are ~head_dim times
    smaller than the arena)."""
    return ()


def host_blocks(params: Mapping, shardings: Dict[str, "ParamSharding"],
                coord: Dict[str, int]) -> Dict[str, Any]:
    """The blocks of a host state dict held at mesh coordinate ``coord``:
    each split leaf sliced on the host by its sharding, the others whole
    (views, no copy). What the leader of a meshed placement sends each
    rank, so that no rank receives a whole leaf its rule splits."""
    out = {}
    for name, leaf in params.items():
        sh = shardings.get(name)
        out[name] = leaf[sh.slices(coord)] if sh is not None \
            and sh.sharded else leaf
    return out


def _rank_grid(mesh) -> np.ndarray:
    """The mesh's grid of global ranks, as numpy."""
    if hasattr(mesh.mesh, "numpy"):
        return mesh.mesh.numpy()  # lint: allow-sync (a host rank tensor)
    return np.asarray(mesh.mesh)


def coordinate_of(mesh, rank: int) -> Dict[str, int]:
    """The mesh coordinate of global rank ``rank`` (any rank of the
    mesh, not only this one)."""
    grid = _rank_grid(mesh)
    where = np.argwhere(grid == rank)
    if not len(where):
        raise ValueError(f"rank {rank} is not in the mesh")
    return dict(zip(mesh.mesh_dim_names, (int(c) for c in where[0])))


def is_cpu_mesh(mesh) -> bool:
    return mesh.device_type == "cpu"


def coordinate(mesh) -> Dict[str, int]:
    """This rank's coordinate on each axis."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError("this rank is not in the mesh")
    return dict(zip(mesh.mesh_dim_names, (int(c) for c in coord)))


def batch_share(mesh, axes: Optional[Tuple[str, ...]] = None
                ) -> Tuple[int, int]:
    """(local, total) batch-dim blocks for this rank: the batch splits
    into ``total`` blocks over the data axes, and a rank holds one of
    them (``(1, 1)`` when no axis splits it)."""
    axes = active_batch_axes(mesh) if axes is None else axes
    if not axes:
        return 1, 1
    sizes = mesh_shape(mesh)
    return 1, math.prod(sizes[a] for a in axes)


def batch_block(mesh) -> int:
    """This rank's block of the batch: its coordinates on the data axes,
    row-major in mesh order (rank 0's rows come first)."""
    sizes, coord = mesh_shape(mesh), coordinate(mesh)
    idx = 0
    for a in active_batch_axes(mesh) or ():
        idx = idx * sizes[a] + coord[a]
    return idx


def local_batch_rows(mesh, global_rows: int) -> int:
    """Rows of a ``global_rows`` batch this rank holds: THE one place the
    division of labour is computed."""
    local, total = batch_share(mesh)
    if global_rows % total:
        raise ValueError(
            f"global batch of {global_rows} rows does not split into "
            f"{total} equal batch shards")
    return global_rows // total * local


def _block(x: np.ndarray, axis: int, index: int, n: int) -> np.ndarray:
    cut = [slice(None)] * x.ndim
    cut[axis] = slice(index * n, (index + 1) * n)
    return x[tuple(cut)]


def local_rows(mesh, x: np.ndarray, axis: int = 0) -> np.ndarray:
    """This rank's block of a global host array along its batch ``axis``."""
    return _block(x, axis, batch_block(mesh),
                  local_batch_rows(mesh, x.shape[axis]))


def local_seq(mesh, x: np.ndarray, seq_axis: Optional[str],
              axis: int = 1) -> np.ndarray:
    """This rank's slice of dim ``axis`` (the sequence) over ``seq_axis``."""
    s = mesh_shape(mesh).get(seq_axis, 1) if seq_axis else 1
    if s == 1 or x.ndim <= axis:
        return x
    if x.shape[axis] % s:
        raise ValueError(f"sequence of {x.shape[axis]} does not split over "
                         f"|{seq_axis}|={s}")
    return _block(x, axis, coordinate(mesh)[seq_axis], x.shape[axis] // s)


def shard_batch(mesh, batch: Any, seq_axis: Optional[str] = None,
                device=None, local: bool = False) -> Any:
    """A host batch on ``device`` as this rank's block: its rows over the
    data axes and, for arrays of rank > 1 under ``seq_axis``, its slice
    of the sequence. The caller says which form ``batch`` has:

    - ``local=False`` (global form): every rank passes the same GLOBAL
      batch and uploads its block of it;
    - ``local=True`` (local-rows form, the reference's multi-process
      contract): ``batch`` holds THIS rank's ``local_batch_rows(mesh, b)``
      rows of a global batch of ``b``, and global row order is block
      order on the data axes (block 0's rows first), so nothing is cut
      but the sequence. Ranks of one data block pass the same rows.
    """
    from mmlspark_tpu_torch.parallel.trainer import to_device
    from mmlspark_tpu_torch.utils import config
    device = config.resolve_device() if device is None else device

    def put(x):
        x = np.asarray(x)
        if not local:
            x = local_rows(mesh, x)
        x = local_seq(mesh, x, seq_axis)
        return to_device(np.ascontiguousarray(x), device)
    if isinstance(batch, Mapping):
        return {k: put(v) for k, v in batch.items()}
    return put(batch)


def gather_local_rows(mesh, data: Mapping, local_batch: int
                      ) -> Dict[str, np.ndarray]:
    """The global host epoch of a local-rows epoch: each data block's
    ``(steps * local_batch)`` rows of ``data`` gathered from the ranks of
    this rank's data group (one host all-gather) and laid out as the
    reference's multi-process epoch, block-cyclic: global batch ``i`` is
    block 0's ``i``-th ``local_batch`` rows, then block 1's, and so on.
    Every rank of the group must hold the same number of rows."""
    from mmlspark_tpu_torch.parallel import collectives
    axes = active_batch_axes(mesh) or ()
    mine = {k: np.asarray(v) for k, v in data.items()}
    gathered = collectives.host_all_gather(
        (batch_block(mesh), mine), axis_group(mesh, axes))
    gathered.sort(key=lambda item: item[0])
    rows = {len(next(iter(b.values()))) for _, b in gathered}
    if len(rows) != 1:
        raise ValueError(f"local epochs differ in rows across the data "
                         f"blocks: {sorted(rows)}; every block pads its "
                         "rows to the same steps x local batch")
    n = rows.pop()
    if n % local_batch:
        raise ValueError(f"local epoch of {n} rows is not a whole number "
                         f"of local batches of {local_batch}")
    steps = n // local_batch
    out = {}
    for k in mine:
        parts = [b[k].reshape((steps, local_batch) + b[k].shape[1:])
                 for _, b in gathered]
        glob = np.concatenate(parts, axis=1)
        out[k] = glob.reshape((steps * glob.shape[1],) + glob.shape[2:])
    return out


# -- process groups over axes ------------------------------------------------

_groups: Dict[Tuple, Any] = {}
_groups_lock = threading.Lock()


def axis_group(mesh, axes: Sequence[str]):
    """The process group of the ranks that differ from this one only on
    ``axes`` (None when those axes are all of size 1). Group ranks ascend
    with global rank: row-major over ``axes`` in mesh order. Groups of
    several axes are made once per mesh layout; every rank must ask for
    the same ones in the same order (``new_group`` is collective)."""
    sizes = mesh_shape(mesh)
    axes = tuple(a for a in AXES if a in axes and sizes.get(a, 1) > 1)
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    grid = _rank_grid(mesh)
    key = (tuple(grid.shape), tuple(grid.flatten().tolist()), axes)  # lint: allow-sync (numpy)
    with _groups_lock:
        if key in _groups:
            return _groups[key]
    import torch.distributed as dist
    keep = [AXES.index(a) for a in axes]
    rest = [i for i in range(grid.ndim) if i not in keep]
    blocks = np.transpose(grid, rest + keep).reshape(
        -1, math.prod(grid.shape[i] for i in keep))
    mine = None
    for ranks in blocks.tolist():  # lint: allow-sync (numpy)
        group = dist.new_group(sorted(ranks))
        if dist.get_rank() in ranks:
            mine = group
    with _groups_lock:
        _groups[key] = mine
    return mine


class MeshLayout:
    """What a meshed step needs of its mesh: the axis sizes, this rank's
    coordinate, the axes whose ranks see different data (``grad_axes``:
    the data axes, and ``seq`` when the sequence is split), and the
    process groups over them."""

    def __init__(self, mesh, seq_axis: Optional[str] = None):
        self.mesh = mesh
        self.sizes = mesh_shape(mesh)
        self.coord = coordinate(mesh)
        self.seq_axis = seq_axis if seq_axis \
            and self.sizes.get(seq_axis, 1) > 1 else None
        self.batch_axes = active_batch_axes(mesh) or ()
        self.grad_axes = tuple(a for a in AXES if a in self.batch_axes
                               or a == self.seq_axis)
        self.n_grad = math.prod(self.sizes[a] for a in self.grad_axes)

    def size(self, axis: str) -> int:
        return self.sizes.get(axis, 1)

    def group(self, *axes: str):
        return axis_group(self.mesh, axes)


_active = threading.local()


def current() -> Optional[MeshLayout]:
    """The layout of the meshed step running on this thread, else None."""
    return getattr(_active, "layout", None)


@contextlib.contextmanager
def activate(layout: Optional[MeshLayout]):
    """Make ``layout`` :func:`current` while a step runs its loss."""
    prev = current()
    _active.layout = layout
    try:
        yield layout
    finally:
        _active.layout = prev


def global_mean(total, count, floor: float = 1.0):
    """``total / max(count, floor)`` over the GLOBAL batch, as GSPMD
    computes a loss: inside a meshed step each rank holds the sums of its
    own rows, so the count is summed over the data ranks and the result
    scaled so that the trainer's mean over them is the global mean.
    Outside a meshed step it is the plain local expression."""
    import torch
    layout = current()
    if layout is None or not layout.grad_axes:
        return total / torch.clamp(count, min=floor)
    from mmlspark_tpu_torch.parallel import collectives
    n = collectives.all_reduce(count.detach().float(),
                               layout.group(*layout.grad_axes))
    return total * layout.n_grad / torch.clamp(n, min=floor)


# -- modules on their shards -------------------------------------------------

def bind_shards(module, shardings: Dict[str, ParamSharding], layout
                ) -> Tuple[Dict[str, Tuple[str, ...]], set]:
    """Bind every submodule that computes on its shards: its
    ``bind_mesh(layout, its leaves' shardings)`` returns ``{leaf: the
    axes it keeps split}`` (a set of names keeps ``tensor``), and it may
    list ``summed_grads``, leaves whose gradient it sums over the data
    ranks itself. Returns ``(claimed, summed)`` by full leaf name."""
    claimed: Dict[str, Tuple[str, ...]] = {}
    summed = set()
    for prefix, sub in module.named_modules():
        bind = getattr(sub, "bind_mesh", None)
        if callable(bind):
            head = f"{prefix}." if prefix else ""
            mine = {n[len(head):]: sh for n, sh in shardings.items()
                    if n.startswith(head)}
            got = bind(layout, mine)
            if not isinstance(got, dict):
                got = {n: ("tensor",) for n in got}
            claimed.update({head + n: tuple(a) for n, a in got.items()})
            summed |= {head + n for n in getattr(sub, "summed_grads", ())}
    return claimed, summed


def gather_plan(module, shardings: Dict[str, ParamSharding],
                claimed: Dict[str, Tuple[str, ...]]) -> List[tuple]:
    """The gathers a split parameter needs before a module that does not
    compute on that split uses it: ``(owner, attr, param, [(dim, axes)],
    kept)`` for each such leaf, ``kept`` its placement over the axes its
    module keeps split (None: gathered whole)."""
    plan = []
    for name, p in module.named_parameters():
        sh = shardings[name]
        keep = claimed.get(name, ())
        ops = [(d, tuple(a for a in _axes(e) if a not in keep))
               for d, e in enumerate(sh.spec)]
        ops = [(d, axes) for d, axes in ops if axes]
        if ops:
            owner_name, _, attr = name.rpartition(".")
            plan.append((module.get_submodule(owner_name), attr, p, ops,
                         sh.keeping(keep) if keep else None))
    return plan


# -- whole tensors and shards ------------------------------------------------

def whole(t, sh: Optional[ParamSharding], layout):
    """The whole of ``t``, a shard split as ``sh`` says (None: not split),
    gathered dim by dim over the ranks holding the other shards. Every
    rank of the mesh must call it (the gathers are collective)."""
    from mmlspark_tpu_torch.parallel import collectives
    t = t.detach()
    if sh is not None:
        for d, e in enumerate(sh.spec):
            if _axes(e):
                t = collectives.all_gather(t.contiguous(), d,
                                           layout.group(*_axes(e)))
    return t


def mine(full, sh: Optional[ParamSharding], layout):
    """This rank's shard of a whole tensor split as ``sh`` says."""
    if sh is None or not sh.sharded:
        return full
    return full[sh.slices(layout.coord)].contiguous()


def _split_of(p) -> Optional[ParamSharding]:
    sh = getattr(p, "_mesh_sharding", None)
    return sh if sh is not None and sh.sharded else None


def whole_state_dict(module) -> Dict[str, Any]:
    """``module.state_dict()`` with every split parameter gathered whole
    (collective on a mesh; the plain state dict otherwise)."""
    params = dict(module.named_parameters())
    return {name: t if name not in params
            else whole(t, _split_of(params[name]),
                       getattr(params[name], "_mesh_layout", None))
            for name, t in module.state_dict().items()}


def local_state_dict(module, full: Dict[str, Any], layout) -> Dict[str, Any]:
    """A whole state dict cut to the shards ``module``'s parameters hold
    on this rank (what ``module.load_state_dict`` takes)."""
    params = dict(module.named_parameters())
    return {name: t if name not in params
            else mine(t, _split_of(params[name]), layout)
            for name, t in full.items()}
