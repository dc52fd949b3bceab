"""Row-sharded embedding tables: the fused sharded lookup and the sparse
update.

The port of ``mmlspark_tpu/embed/tables.py``. Recommender tables grow with
the business, not the architecture, so they split by ROW over the
``tensor`` mesh axis (``parallel/sharding.py::embedding_table_sharding``:
rank t of the axis holds rows ``[t*R/T, (t+1)*R/T)``), and the lookup and
the update are written so that no rank ever holds a whole table, a whole
gather, or a dense gradient of rows it does not hold.

The fused lookup, on each rank for its block of the batch (its ids are
replicated over ``tensor``: every row shard sees every id of the block):

1. **bucketize**: sort the flat ids by owning shard (``id //
   rows_per_shard``, a stable sort) and pack each shard's requests into
   a bucket row of capacity n, the block's id count;
2. **all-to-all** the request buckets over ``tensor``: a rank then holds
   every shard's requests for the rows it owns;
3. **local gather** of the rows it holds;
4. **all-to-all** the rows back, and un-permute them into the ids' order;
5. **sum the weighted bags** slot by slot (slot 0 first, as the
   reference's ``segment_sum`` adds them).

Each row reaching a bag is the reference's row, and the bags add the same
products in the same order, so the fused lookup is BIT-identical to
:func:`bag_lookup_reference` on the same inputs, on the CPU and the card.

The gradient never moves a dense table either: :func:`make_sparse_grad`
all-gathers ``(ids, weights, cotangents)`` over the data axes (O(batch)
bytes) and scatter-adds the whole batch's contributions into the rows
the rank owns, in global batch order. The result is the full-batch sum on
every data rank already, so ``DistributedTrainer`` leaves such a leaf out
of its data all-reduce and only divides it by the data ranks' count, as
it divides every gradient (:class:`mmlspark_tpu_torch.embed.model.DLRM`
names it in ``summed_grads``). :func:`make_bag_lookup` wraps both as a
``torch.autograd.Function`` whose ids and weights get zero cotangents.

Scatter-adds run through :func:`_scatter_rows`: ``index_add_`` on the CPU
(serial, in index order) and ``index_put_(accumulate=True)`` on the card
(sort-based, the same order), so repeated ids add in the order of the
batch on either device.
"""
from __future__ import annotations

import zlib
from typing import Any, Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.parallel import collectives
from mmlspark_tpu_torch.parallel import sharding
from mmlspark_tpu_torch.utils import config as mmlconfig

# id 0 is the pad slot in every table: lookups still FETCH row 0 (static
# shapes; masking happens through the weight), so row 0 is reserved and
# real ids start at 1
PAD_ID = 0


class EmbeddingTable(NamedTuple):
    """One logical table: ``rows`` ids (the pad row 0 included) of ``dim``
    features; ``rows`` pads up to the tensor-axis multiple at placement,
    the pad rows dead weight that keeps every shard the same shape."""
    name: str
    rows: int
    dim: int

    def padded_rows(self, mesh) -> int:
        t = sharding.tensor_axis_size(mesh)
        return -(-self.rows // t) * t

    def logical_bytes(self, dtype=np.float32) -> int:
        return int(self.rows) * int(self.dim) * np.dtype(dtype).itemsize


def _flat_ids(ids: torch.Tensor) -> torch.Tensor:
    return ids.reshape(-1).long()


def _scatter_rows(out: torch.Tensor, idx: torch.Tensor,
                  src: torch.Tensor) -> torch.Tensor:
    """``out[idx[i]] += src[i]`` for rows, each row's updates summed in
    the order of ``i`` on either device."""
    if out.device.type == "cuda":
        return out.index_put_((idx,), src, accumulate=True)
    return out.index_add_(0, idx, src)


def _bag_sum(vals: torch.Tensor, b: int, slots: int) -> torch.Tensor:
    """(b*slots, dim) weighted rows -> (b, dim) bags, slot 0 first."""
    vals = vals.reshape(b, slots, -1)
    out = vals[:, 0]
    for s in range(1, slots):
        out = out + vals[:, s]
    return out


def bag_lookup_reference(table: torch.Tensor, ids: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """Unsharded bag lookup: gather, then the weighted sum of each bag.
    The numerics the fused sharded path must match bit for bit."""
    b, slots = ids.shape
    emb = table.index_select(0, _flat_ids(ids))            # (b*slots, dim)
    vals = emb * weights.reshape(-1)[:, None].to(table.dtype)
    return _bag_sum(vals, b, slots)


def _bucketize(flat: torch.Tensor, rows_per_shard: int, t: int):
    """Sort a flat id block by owning shard and pack per-shard request
    buckets. Returns ``(buckets, order, sorted_owner, pos)``:
    ``buckets[j, c]`` is the c-th local row asked of shard j (capacity the
    whole block: in the worst case every id lies on one shard)."""
    n = flat.shape[0]
    owner = torch.div(flat, rows_per_shard, rounding_mode="floor")
    local = flat - owner * rows_per_shard
    order = torch.sort(owner, stable=True).indices
    sorted_owner = owner[order]
    sorted_local = local[order]
    start = torch.searchsorted(sorted_owner,
                               torch.arange(t, device=flat.device))
    pos = torch.arange(n, device=flat.device) - start[sorted_owner]
    buckets = torch.zeros((t, n), dtype=flat.dtype, device=flat.device)
    buckets[sorted_owner, pos] = sorted_local
    return buckets, order, sorted_owner, pos


def _fused(mesh) -> bool:
    return (mesh is not None and sharding.tensor_axis_size(mesh) > 1
            and bool(mmlconfig.get("embed.fused_lookup")))


def make_fused_lookup(mesh):
    """``(table_shard, ids, weights) -> bags`` on this mesh: this rank's
    row shard of the table and its block of the batch. Without a mesh
    with a ``tensor`` axis, or with ``embed.fused_lookup`` off, the
    reference path (on the whole table)."""
    if not _fused(mesh):
        return bag_lookup_reference
    group = sharding.axis_group(mesh, ("tensor",))
    t = sharding.tensor_axis_size(mesh)

    def lookup(tab, ids, weights):
        rows_per_shard = tab.shape[0]
        b, slots = ids.shape
        flat = _flat_ids(ids)
        buckets, order, sorted_owner, pos = _bucketize(flat, rows_per_shard,
                                                       t)
        # requests OUT: row j of the result is what rank j asked of us
        req = collectives.all_to_all(buckets, group)
        got = tab[req]                                # (t, n, dim) our rows
        # rows BACK: bucket j of the result is what rank j answered
        back = collectives.all_to_all(got, group)
        emb = torch.empty_like(back[0])
        emb[order] = back[sorted_owner, pos]          # the ids' order
        vals = emb * weights.reshape(-1)[:, None].to(tab.dtype)
        return _bag_sum(vals, b, slots)
    return lookup


def _reference_table_grad(rows: int, ids: torch.Tensor,
                          weights: torch.Tensor,
                          grad_bags: torch.Tensor) -> torch.Tensor:
    """Unsharded sparse table gradient: each bag's cotangent times its
    weight, scatter-added into the rows its ids touched."""
    dim = grad_bags.shape[-1]
    vals = (grad_bags[:, None, :] * weights[..., None].to(grad_bags.dtype)
            ).reshape(-1, dim)
    out = torch.zeros((rows, dim), dtype=grad_bags.dtype,
                      device=grad_bags.device)
    return _scatter_rows(out, _flat_ids(ids), vals)


def make_sparse_grad(mesh):
    """``(table_shard, ids, weights, grad_bags) -> grad_shard`` on this
    mesh: the ``(ids, weights, cotangents)`` of every data rank are
    gathered (O(batch) bytes) and the whole batch's contributions to the
    rows this rank owns are scatter-added, in global batch order. The
    result is the gradient of the sum of the ranks' losses, the same on
    every data rank; no dense O(table) all-reduce runs."""
    if not _fused(mesh):
        return lambda tab, ids, w, g: _reference_table_grad(
            tab.shape[0], ids, w, g)
    data = sharding.axis_group(mesh, sharding.active_batch_axes(mesh) or ())
    me = sharding.coordinate(mesh)["tensor"]

    def grad_fn(tab, ids, weights, grad_bags):
        rows_per_shard = tab.shape[0]
        dim = grad_bags.shape[-1]
        ids = collectives.all_gather(ids.contiguous(), 0, data)
        weights = collectives.all_gather(
            weights.to(grad_bags.dtype).contiguous(), 0, data)
        grad_bags = collectives.all_gather(grad_bags.contiguous(), 0, data)
        flat = _flat_ids(ids)
        owner = torch.div(flat, rows_per_shard, rounding_mode="floor")
        mine = owner == me
        vals = (grad_bags[:, None, :] * weights[..., None]).reshape(-1, dim)
        # others' rows add zeros to row 0 (a mask, not a selection: the
        # shapes stay static and nothing waits on the device)
        vals = torch.where(mine[:, None], vals, torch.zeros_like(vals))
        rows = torch.where(mine, flat - owner * rows_per_shard,
                           torch.zeros_like(flat))
        return _scatter_rows(torch.zeros_like(tab), rows, vals)
    return grad_fn


def sparse_table_grads(mesh, table: torch.Tensor, ids: torch.Tensor,
                       weights: torch.Tensor,
                       grad_bags: torch.Tensor) -> torch.Tensor:
    """One-shot convenience over :func:`make_sparse_grad`."""
    return make_sparse_grad(mesh)(table, ids, weights, grad_bags)


class _BagLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, weights, lookup, grad_fn):
        ctx.grad_fn = grad_fn
        ctx.save_for_backward(table, ids, weights)
        return lookup(table, ids, weights)

    @staticmethod
    def backward(ctx, grad_bags):
        table, ids, weights = ctx.saved_tensors
        grad_table = ctx.grad_fn(table, ids, weights, grad_bags.contiguous())
        grad_w = torch.zeros_like(weights) if ctx.needs_input_grad[2] \
            else None
        return grad_table, None, grad_w, None, None


def make_bag_lookup(mesh=None):
    """A differentiable bag lookup for this mesh: forward the fused
    all-to-all path (the reference path unsharded), backward the sparse
    scatter-add gradient, so a module calling it trains through
    ``DistributedTrainer`` with its table gradient sparse and sharded,
    never a dense dL/dTable. The ids and weights (pad masks, frequency
    features) get zero cotangents."""
    lookup = make_fused_lookup(mesh)
    grad_fn = make_sparse_grad(mesh)

    def bag_lookup(table, ids, weights):
        return _BagLookup.apply(table, ids, weights, lookup, grad_fn)
    return bag_lookup


class EmbeddingCollection:
    """A named set of row-sharded tables and their lookup and update,
    bound to one mesh (or none: the one-device reference).

    Usage, on every rank of the mesh::

        coll = EmbeddingCollection([EmbeddingTable("user", 100_000, 64),
                                    EmbeddingTable("item", 200_000, 64)],
                                   mesh=mesh)
        tables = coll.place(coll.init(seed=0))   # this rank's row shards
        bags = coll.lookup(tables, {"user": (ids, w), "item": (ids2, w2)})
        grads = coll.grads(tables, batch, grad_bags)   # sparse, sharded
        tables = coll.sgd_update(tables, grads, lr=0.05)

    ``ids``, weights and ``grad_bags`` are this rank's block of the batch
    (its rows over the data axes)."""

    def __init__(self, tables: Sequence[EmbeddingTable], mesh=None,
                 dtype=torch.float32, device=None):
        names = [t.name for t in tables]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate table names: {names}")
        self.tables: Dict[str, EmbeddingTable] = {t.name: t for t in tables}
        self.mesh = mesh
        self.dtype = dtype
        self.device = mmlconfig.resolve_device() if device is None \
            else torch.device(device)
        self._lookup = make_fused_lookup(mesh)
        self._grad = make_sparse_grad(mesh)

    # -- residency -----------------------------------------------------------
    def init(self, seed: int = 0) -> Dict[str, np.ndarray]:
        """Host init (scaled-normal rows, the pad row zero), PADDED to the
        mesh's shard multiple: the one set of values every mesh shape
        loads. Each table's generator is seeded with ``(seed, crc32 of
        its name)``."""
        out: Dict[str, np.ndarray] = {}
        for name, spec in sorted(self.tables.items()):
            rng = np.random.default_rng(
                (seed, zlib.crc32(name.encode()) & 0xFFFF))
            arr = rng.normal(0.0, spec.dim ** -0.5,
                             size=(spec.padded_rows(self.mesh), spec.dim))
            arr = arr.astype(np.dtype(str(self.dtype).split(".")[-1]))
            arr[PAD_ID] = 0.0
            arr[spec.rows:] = 0.0       # shard-padding rows
            out[name] = arr
        return out

    def place(self, host_tables: Dict[str, np.ndarray]
              ) -> Dict[str, torch.Tensor]:
        """Host arrays -> this rank's row shard of each on the device
        (the whole table without a mesh): no rank uploads a whole one."""
        spec = sharding.embedding_table_sharding(self.mesh)
        out = {}
        for name, arr in host_tables.items():
            if spec and self.mesh is not None:
                t = sharding.tensor_axis_size(self.mesh)
                step = arr.shape[0] // t
                me = sharding.coordinate(self.mesh)["tensor"]
                arr = arr[me * step:(me + 1) * step]
            out[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(
                self.device)
        return out

    # -- compute -------------------------------------------------------------
    def lookup(self, tables: Dict[str, torch.Tensor],
               batch: Dict[str, Tuple[Any, Any]]) -> Dict[str, torch.Tensor]:
        """The fused bag lookup per table; ``batch`` maps a table's name
        to ``(ids, weights)`` of shape (b, slots)."""
        return {name: self._lookup(tables[name], ids, w)
                for name, (ids, w) in batch.items()}

    def grads(self, tables: Dict[str, torch.Tensor],
              batch: Dict[str, Tuple[Any, Any]],
              grad_bags: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {name: self._grad(tables[name], ids, w, grad_bags[name])
                for name, (ids, w) in batch.items()}

    def sgd_update(self, tables: Dict[str, torch.Tensor],
                   grads: Dict[str, torch.Tensor],
                   lr: float) -> Dict[str, torch.Tensor]:
        """The sparse update's half of a step: ``table - lr * grad`` on
        each rank's shard."""
        return {name: tables[name] - lr * grads[name] for name in tables}

    # -- accounting ----------------------------------------------------------
    def logical_bytes(self) -> int:
        """Bytes of the whole (unsharded, padded) tables: what must exceed
        one card's budget for a workload to cross the card."""
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return sum(t.padded_rows(self.mesh) * t.dim * itemsize
                   for t in self.tables.values())


class RowResidency:
    """Frequency-capped per-row hot pool over one host master table.

    The registry's eviction is whole-table; a table many times the budget
    can still serve from residency because real id traffic is Zipfian.
    This pool admits rows on first touch and evicts the COLDEST first when
    full: each resident row keeps an access counter capped at
    ``freq_cap``, and victims sort by ``(capped frequency, last touch,
    id)``, so a row that was hot long ago cannot outrank newly hot rows
    for more than ~``freq_cap`` touches.

    Ledger contract: resident bytes are published to the memory ledger as
    ``kind="table"`` under ``model`` after every admit and evict, and
    :meth:`close` frees the pool and reconciles the line to ZERO. Lookups
    are bit-identical to indexing the master (rows are copied, never
    transformed)."""

    def __init__(self, model: str, master: np.ndarray,
                 capacity_rows: int, freq_cap: int = 15, ledger=None):
        if capacity_rows <= 0:
            raise ValueError(f"capacity_rows must be > 0, got "
                             f"{capacity_rows}")
        if freq_cap <= 0:
            raise ValueError(f"freq_cap must be > 0, got {freq_cap}")
        from mmlspark_tpu_torch.observability import memory as devmem
        self.model = str(model)
        self._master = master
        self._cap = int(capacity_rows)
        self._freq_cap = int(freq_cap)
        self._ledger = ledger if ledger is not None else devmem.get_ledger()
        self._row_bytes = devmem.nbytes_of(master.shape[1:], master.dtype)
        self._pool = np.zeros((self._cap,) + master.shape[1:], master.dtype)
        self._slot: Dict[int, int] = {}      # id -> pool slot
        self._freq: Dict[int, int] = {}      # id -> capped touch count
        self._touch: Dict[int, int] = {}     # id -> logical tick
        self._free = list(range(self._cap - 1, -1, -1))
        self._tick = 0
        self._closed = False
        self.evictions = 0
        self.misses = 0
        self.hits = 0
        self._charge()

    def _charge(self) -> None:
        self._ledger.set_bytes(self.model, "table",
                               len(self._slot) * self._row_bytes)

    def _evict_cold(self, n: int) -> None:
        # coldest first: lowest capped frequency, then stalest touch, then
        # the id, so two runs evict alike
        victims = sorted(self._slot,
                         key=lambda i: (self._freq[i], self._touch[i], i))
        for rid in victims[:n]:
            self._free.append(self._slot.pop(rid))
            del self._freq[rid], self._touch[rid]
            self.evictions += 1

    def lookup(self, ids: Sequence[int]) -> np.ndarray:
        """Rows for ``ids`` (bit-identical to ``master[ids]``), touching
        or admitting each id through the pool."""
        if self._closed:
            raise RuntimeError(f"RowResidency {self.model!r} is closed")
        out = np.empty((len(ids),) + self._master.shape[1:],
                       self._master.dtype)
        for j, rid in enumerate(ids):
            rid = int(rid)
            self._tick += 1
            slot = self._slot.get(rid)
            if slot is None:
                self.misses += 1
                if not self._free:
                    self._evict_cold(1)
                slot = self._free.pop()
                self._pool[slot] = self._master[rid]
                self._slot[rid] = slot
                self._freq[rid] = 1
            else:
                self.hits += 1
                self._freq[rid] = min(self._freq[rid] + 1, self._freq_cap)
            self._touch[rid] = self._tick
            out[j] = self._pool[slot]
        self._charge()
        return out

    @property
    def resident_rows(self) -> int:
        return len(self._slot)

    def resident_bytes(self) -> int:
        return len(self._slot) * self._row_bytes

    def stats(self) -> Dict[str, int]:
        return {"resident_rows": len(self._slot),
                "capacity_rows": self._cap,
                "resident_bytes": self.resident_bytes(),
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}

    def close(self) -> None:
        """Free the pool and reconcile the ledger line to ZERO (the
        registry eviction's close contract, at row granularity)."""
        if self._closed:
            return
        self._closed = True
        self._slot.clear()
        self._freq.clear()
        self._touch.clear()
        self._free = list(range(self._cap - 1, -1, -1))
        self._charge()


__all__ = ["EmbeddingCollection", "EmbeddingTable", "PAD_ID",
           "RowResidency", "bag_lookup_reference", "make_bag_lookup",
           "make_fused_lookup", "make_sparse_grad", "sparse_table_grads"]
