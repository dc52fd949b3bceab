"""Paged KV-cache arena for the generative serving lane.

The port of ``mmlspark_tpu/serve/kvcache.py``. Autoregressive decode is
memory-bound on the key/value history: a per-sequence ``(max_seq_len,
heads, head_dim)`` allocation wastes device memory on short sequences and
fragments it as sequences of different lengths join and leave the
in-flight batch. The vLLM-style answer (PAPERS.md: PagedAttention): ONE
fixed arena of ``num_blocks`` fixed-size blocks per layer, allocated once,
with a host-side block ledger handing ``ceil(len / block_tokens)`` blocks
to each admitted sequence and reclaiming them the step the sequence
finishes.

Contracts the rest of the lane builds on:

- **Fixed footprint.** The arena never grows. Admission that cannot get
  its blocks is SHED (a retryable ``ServerOverloaded``) — decode never
  runs out mid-sequence, because a sequence's full block budget (prompt +
  ``max_new_tokens``) is reserved up front.
- **Block 0 is reserved scratch.** Decode programs run at a fixed batch
  bucket; lanes without a live sequence route their (masked, garbage)
  writes to block 0 so the program never branches on occupancy.
- **Shared-prefix reuse (refcounted blocks).** Full prompt blocks are
  content-addressed under a CHAINED hash (``sha256(prev_hash | token
  block)``); a later reservation carrying the same chain shares the block
  instead of re-prefilling it. A block is writable only at refcount 1
  (copy-on-write otherwise — :meth:`KVCacheManager.prepare_write`), and a
  freed block that still holds indexed content parks in an LRU cached
  pool, reclaimed when admission needs room.
- **Written in place.** The arena is two tensors of shape ``(layers,
  num_blocks, block_tokens, heads, head_dim)`` on the lane's device, in
  the model's dtype. The programs write them in place (``index_copy_`` /
  ``index_put_``), so a CUDA graph replay needs no new allocation and the
  arena's addresses never move. :meth:`KVCacheManager.swap` stores a new
  arena set for callers that built one out of place.
- **int8 storage (optional).** ``generate.kv_dtype="int8"`` stores the
  arena quantized with one fp32 scale per (layer, block, row), two
  ``(layers, num_blocks, block_tokens)`` scale planes beside the int8
  arenas: about twice the blocks of a bf16 arena at one
  ``generate.arena_mb``. :func:`quantize_rows` / :func:`dequantize_rows`
  are the only quantization arithmetic of the lane; the programs call
  them inside their graphs.
- **Budget accounting.** ``arena_bytes()`` (arena + scales, at the real
  width) is charged to the owning
  :class:`~mmlspark_tpu_torch.serve.registry.ModelEntry` so the registry's
  ``runtime.device_cache_mb`` LRU sees params and arena as one tenant.

The host ledger is the reference's, unchanged.
"""
from __future__ import annotations

import hashlib
import math
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.observability import memory as devmem
from mmlspark_tpu_torch.observability import metrics
from mmlspark_tpu_torch.utils import config as mmlconfig

RESERVED_BLOCK = 0  # scratch target for masked decode lanes; never leased


def blocks_needed(tokens: int, block_tokens: int) -> int:
    """Blocks covering ``tokens`` positions at the arena granule."""
    return max(1, math.ceil(int(tokens) / int(block_tokens)))


def prefix_block_hashes(model: str, kv_dtype: str, prompt: Sequence[int],
                        block_tokens: int) -> List[str]:
    """Chained content hashes for every FULL block of ``prompt``.

    ``h[i] = sha256(h[i-1] | tokens of block i)`` — the chain makes a
    block's identity a function of the ENTIRE prefix through it, which is
    what its cached K/V actually depends on. The partial trailing block
    (if any) is never hashed: its K/V would be extended in place by
    decode, so it is never shareable.
    """
    toks = np.asarray(prompt, np.int32).ravel()
    out: List[str] = []
    prev = f"{model}|{kv_dtype}|bt={int(block_tokens)}".encode()
    for i in range(int(toks.size) // int(block_tokens)):
        h = hashlib.sha256()
        h.update(prev)
        h.update(toks[i * block_tokens:(i + 1) * block_tokens].tobytes())
        prev = h.digest()
        out.append(h.hexdigest())
    return out


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``: the name the reference's
    numpy / ml_dtypes dtypes carry, which seeds the prefix hashes."""
    return str(dtype).replace("torch.", "")


def storage_dtype(kv_dtype: Any) -> Optional[torch.dtype]:
    """``generate.kv_dtype`` -> the arena's storage dtype (None: the
    model's own). Only ``"int8"`` stores differently."""
    name = str(kv_dtype or "").strip().lower()
    if not name:
        return None
    if name != "int8":
        raise ValueError(
            f"generate.kv_dtype={kv_dtype!r}: \"\" (the model's dtype) or "
            "\"int8\"")
    return torch.int8


# ---------------------------------------------------------------------------
# int8 block quantization, called inside the prefill / decode / chunk /
# verify programs. Per-row scales keep incremental single-position writes
# exact (a whole-block scale would invalidate rows already written).


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(..., heads, head_dim)`` float rows -> (int8 rows, fp32 scales
    shaped ``(...,)``): symmetric per-row absmax scaling to [-127, 127],
    rounding half to even as ``jnp.round`` does."""
    xf = x.float()
    amax = xf.abs().amax(dim=(-2, -1))
    # a tensor divisor: CUDA turns division by a Python scalar into a
    # multiply by its reciprocal, one ulp off the reference's quotient
    scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)
    q = torch.clamp(torch.round(xf / scale[..., None, None]), -127.0, 127.0)
    return q.to(torch.int8), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Invert :func:`quantize_rows`: int8 rows + per-row scales -> fp32."""
    return q.float() * scale[..., None, None].float()


class KVCacheManager:
    """Fixed paged KV arena + host-side block ledger (thread-safe).

    The device tensors ``arena_k`` / ``arena_v`` are shaped
    ``(layers, num_blocks, block_tokens, heads, head_dim)``; the ledger
    (free list, refcounts, prefix index, per-sequence leases) lives
    entirely on the host and never touches the device on reserve/free.

    Block lifecycle::

        free -> leased (refcount 1..N, shared via the prefix index)
             -> cached (refcount 0, content still indexed; LRU)
             -> free  (evicted under admission pressure, or de-indexed)
    """

    def __init__(self, *, layers: int, heads: int, head_dim: int,
                 num_blocks: int, block_tokens: int,
                 dtype: torch.dtype = torch.float32, kv_dtype=None,
                 device=None, mesh=None, shard_heads: bool = True):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block {RESERVED_BLOCK} is "
                f"reserved scratch), got {num_blocks}")
        if block_tokens < 1:
            raise ValueError(f"block_tokens must be >= 1, got {block_tokens}")
        self.layers = int(layers)
        self.heads = int(heads)
        self.head_dim = int(head_dim)
        self.num_blocks = int(num_blocks)
        self.block_tokens = int(block_tokens)
        self.compute_dtype = dtype
        storage = (kv_dtype if isinstance(kv_dtype, torch.dtype)
                   else storage_dtype(kv_dtype))
        self.dtype = storage if storage is not None else dtype
        self.dtype_name = dtype_name(self.dtype)
        self.quantized = self.dtype == torch.int8
        self.device = (torch.device(device) if device is not None
                       else mmlconfig.resolve_device())
        # on a mesh the head dim splits over `tensor` (the attention
        # projections' split, so each rank attends over the heads it
        # computed) unless shard_heads is off; the scales carry no head
        # dim and stay whole. This rank's arena holds ``local_heads``; the
        # host ledger below is the same on every rank
        self.mesh = mesh
        self.arena_sharding = self.scale_sharding = None
        self.local_heads = self.heads
        if mesh is not None:
            from mmlspark_tpu_torch.parallel.sharding import (
                kv_arena_sharding, kv_scale_sharding, tensor_axis_size,
            )
            self.arena_sharding = kv_arena_sharding(mesh, self.heads) \
                if shard_heads else ()
            self.scale_sharding = kv_scale_sharding(mesh)
            if self.arena_sharding:
                self.local_heads = self.heads // tensor_axis_size(mesh)
        shape = (self.layers, self.num_blocks, self.block_tokens,
                 self.local_heads, self.head_dim)
        self.arena_k = torch.zeros(shape, dtype=self.dtype,
                                   device=self.device)
        self.arena_v = torch.zeros(shape, dtype=self.dtype,
                                   device=self.device)
        if self.quantized:
            sshape = (self.layers, self.num_blocks, self.block_tokens)
            self.scale_k = torch.ones(sshape, dtype=torch.float32,
                                      device=self.device)
            self.scale_v = torch.ones(sshape, dtype=torch.float32,
                                      device=self.device)
        else:
            self.scale_k = self.scale_v = None
        self._lock = threading.Lock()
        # LIFO free list: recently-freed blocks are re-leased first, which
        # keeps the hot working set compact
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._leases: Dict[str, List[int]] = {}
        # prefix-reuse ledger: refcounts for leased blocks, the content
        # index (chained hash -> block, 1:1 both ways), the LRU pool of
        # refcount-0 blocks still holding indexed content, and per-lease
        # reservation metadata (hit counts + pending copy-on-write)
        self._refcount: Dict[int, int] = {}
        self._index: Dict[str, int] = {}
        self._block_hash: Dict[int, str] = {}
        self._cached: "OrderedDict[int, str]" = OrderedDict()
        self._meta: Dict[str, Dict[str, Any]] = {}
        # per-hash chain metadata (parent link, registration depth, hit
        # count, last-use tick): the source of the resident-chain summary
        self._hmeta: Dict[str, Dict[str, Any]] = {}
        self._tick = 0
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.cow_copies = 0
        self.prefix_evictions = 0
        self._update_gauge()

    # -- sizing ------------------------------------------------------------
    @classmethod
    def from_config(cls, *, layers: int, heads: int, head_dim: int,
                    dtype: torch.dtype = torch.float32,
                    device=None, mesh=None,
                    shard_heads: bool = True) -> "KVCacheManager":
        """Size the arena from the ``generate.*`` config namespace:
        ``generate.arena_mb`` when set, else enough blocks for
        ``generate.max_sequences`` sequences of ``generate.max_seq_len``
        tokens (plus the reserved scratch block). ``generate.kv_dtype``
        picks the storage width: at a fixed ``arena_mb``, int8 storage buys
        about twice the blocks of a bf16 arena."""
        if device is None:
            device = mmlconfig.resolve_device()
        bt = int(mmlconfig.get("generate.kv_block_tokens"))
        arena_mb = float(mmlconfig.get("generate.arena_mb"))
        kv_dtype = storage_dtype(mmlconfig.get("generate.kv_dtype"))
        if arena_mb > 0:
            storage = kv_dtype if kv_dtype is not None else dtype
            per_block = devmem.nbytes_of((2, layers, bt, heads, head_dim),
                                         storage)
            if storage == torch.int8:
                per_block += devmem.nbytes_of((2, layers, bt),
                                              torch.float32)
            num_blocks = max(2, int(arena_mb * 1e6 // per_block))
        else:
            seqs = int(mmlconfig.get("generate.max_sequences"))
            max_len = int(mmlconfig.get("generate.max_seq_len"))
            num_blocks = 1 + seqs * blocks_needed(max_len, bt)
        return cls(layers=layers, heads=heads, head_dim=head_dim,
                   num_blocks=num_blocks, block_tokens=bt, dtype=dtype,
                   kv_dtype=kv_dtype, device=device, mesh=mesh,
                   shard_heads=shard_heads)

    def arena_bytes(self) -> int:
        """Device bytes of both arenas at their real storage width, plus
        the quantization scales when int8 (charged to the owning registry
        entry); the arithmetic lives in the device-memory ledger."""
        n = 2 * devmem.nbytes_of(
            (self.layers, self.num_blocks, self.block_tokens,
             self.heads, self.head_dim), self.dtype)
        if self.quantized:
            n += 2 * devmem.nbytes_of(
                (self.layers, self.num_blocks, self.block_tokens),
                torch.float32)
        return n

    def arena_shard_bytes(self) -> int:
        """Device bytes of this rank's share of the arena: the arena over
        the heads it holds (all of them unless head-sharded), plus the
        whole scales when int8. What the registry charges a rank: a
        head-sharded arena costs each rank 1/|tensor| of
        :meth:`arena_bytes`' arena."""
        n = 2 * devmem.nbytes_of(
            (self.layers, self.num_blocks, self.block_tokens,
             self.local_heads, self.head_dim), self.dtype)
        if self.quantized:
            n += 2 * devmem.nbytes_of(
                (self.layers, self.num_blocks, self.block_tokens),
                torch.float32)
        return n

    def unquantized_arena_bytes(self) -> int:
        """What the same block count would cost at the compute dtype: the
        denominator of the int8 savings."""
        return 2 * devmem.nbytes_of(
            (self.layers, self.num_blocks, self.block_tokens,
             self.heads, self.head_dim), self.compute_dtype)

    def swap(self, arena_k, arena_v, scale_k=None, scale_v=None) -> None:
        """Store an arena set built out of place (the programs write in
        place, so they never need this)."""
        self.arena_k = arena_k
        self.arena_v = arena_v
        if scale_k is not None:
            self.scale_k = scale_k
        if scale_v is not None:
            self.scale_v = scale_v

    # -- ledger internals (call under self._lock) --------------------------
    def _bump(self, block: int) -> None:
        """Take a share of ``block``: out of the cached pool if parked
        there, refcount += 1."""
        self._cached.pop(block, None)
        self._refcount[block] = self._refcount.get(block, 0) + 1

    def _drop(self, block: int) -> None:
        """Release one share of ``block``; at refcount 0 it parks in the
        cached pool (content still indexed) or returns to the free list."""
        n = self._refcount.get(block, 0) - 1
        if n > 0:
            self._refcount[block] = n
            return
        self._refcount.pop(block, None)
        h = self._block_hash.get(block)
        if h is not None:
            self._cached[block] = h
            self._cached.move_to_end(block)
        else:
            self._free.append(block)

    def _deindex(self, block: int) -> None:
        h = self._block_hash.pop(block, None)
        if h is not None:
            self._index.pop(h, None)
            self._hmeta.pop(h, None)

    def _take_fresh(self) -> Optional[int]:
        """One content-free block: the free list first, then the LRU
        refcount-0 cached block (its index entry dies with it)."""
        if self._free:
            return self._free.pop()
        if self._cached:
            block, _h = self._cached.popitem(last=False)
            self._deindex(block)
            self.prefix_evictions += 1
            return block
        return None

    # -- reservation -------------------------------------------------------
    def try_reserve(self, seq_id: str, tokens: int,
                    prefix_hashes: Optional[Sequence[str]] = None,
                    prompt_tokens: Optional[int] = None
                    ) -> Optional[List[int]]:
        """Lease blocks covering ``tokens`` positions for ``seq_id``.

        With ``prefix_hashes`` (the prompt's chained full-block hashes),
        leading blocks already in the prefix index are SHARED (refcount
        bump) instead of drawn from the free list — the reservation only
        pays for the uncached suffix. When the hits cover the whole
        prompt (``prompt_tokens`` block-aligned and fully matched), the
        final matched block is scheduled for copy-on-write instead of
        shared writable: the joiner's first-token recompute writes into
        position ``prompt_tokens - 1``, and no block is ever written
        while shared (see :meth:`take_pending_cow`).

        Returns the position-ordered block ids (stable for the
        sequence's lifetime) or None when free + reclaimable-cached
        blocks cannot cover the uncached ask — the caller sheds the
        request (retryable) instead of queueing into an OOM.
        """
        n = blocks_needed(tokens, self.block_tokens)
        hashes = list(prefix_hashes or ())
        with self._lock:
            if seq_id in self._leases:
                raise ValueError(f"sequence {seq_id!r} already holds blocks")
            matched: List[int] = []
            for h in hashes:
                b = self._index.get(h)
                if b is None or len(matched) >= n:
                    break
                matched.append(b)
            m = len(matched)
            full_hit = bool(hashes) and m == len(hashes) \
                and prompt_tokens is not None \
                and m * self.block_tokens >= int(prompt_tokens)
            shared = matched[:-1] if full_hit else matched
            cow_src = matched[-1] if full_hit else None
            fresh_needed = n - len(shared)
            reclaimable = len(self._free) + sum(
                1 for b in self._cached if b not in matched)
            if reclaimable < fresh_needed:
                return None                 # nothing mutated: clean shed
            # hit heat only moves once the reservation is COMMITTED — a
            # shed mutates nothing, including the digest's hit counters
            self._tick += 1
            for h in hashes[:m]:
                hm = self._hmeta.get(h)
                if hm is not None:
                    hm["hits"] += 1
                    hm["last_use"] = self._tick
            for b in shared:
                self._bump(b)
            if cow_src is not None:
                self._bump(cow_src)         # pin the copy source
            fresh: List[int] = []
            for _ in range(fresh_needed):
                b = self._take_fresh()
                assert b is not None        # guaranteed by the count above
                self._refcount[b] = 1
                fresh.append(b)
            blocks = list(shared) + fresh
            self._leases[seq_id] = blocks
            self._meta[seq_id] = {
                "hits": m,
                "misses": max(0, len(hashes) - m),
                "cached_tokens": m * self.block_tokens,
                "pending_cow": (cow_src, fresh[0]) if full_hit else None,
            }
            self.prefix_hits += m
            self.prefix_misses += max(0, len(hashes) - m)
        self._update_gauge()
        return list(blocks)

    def reserve_info(self, seq_id: str) -> Dict[str, Any]:
        """Reservation metadata recorded by :meth:`try_reserve`:
        ``hits`` / ``misses`` (prefix blocks), ``cached_tokens`` (prompt
        positions whose K/V needs no prefill), ``pending_cow``."""
        with self._lock:
            meta = self._meta.get(seq_id)
            return dict(meta) if meta else {
                "hits": 0, "misses": 0, "cached_tokens": 0,
                "pending_cow": None}

    # -- copy-on-write -----------------------------------------------------
    def take_pending_cow(self, seq_id: str) -> Optional[Tuple[int, int]]:
        """The (src, dst) block copy a full-prefix-hit reservation owes
        before its first write, or None. The caller copies src -> dst on
        device, then calls :meth:`cow_done` to release the src pin."""
        with self._lock:
            meta = self._meta.get(seq_id)
            return meta["pending_cow"] if meta else None

    def cow_done(self, seq_id: str) -> None:
        """Mark the pending copy complete: unpin the source block and
        count the copy."""
        with self._lock:
            meta = self._meta.get(seq_id)
            if not meta or not meta["pending_cow"]:
                return
            src, _dst = meta["pending_cow"]
            meta["pending_cow"] = None
            self.cow_copies += 1
            self._drop(src)
        self._update_gauge()

    def prepare_write(self, seq_id: str, block_index: int
                      ) -> Optional[Tuple[int, int]]:
        """Write barrier: make the block at position ``block_index`` of
        ``seq_id``'s lease writable.

        Refcount 1: de-index it (the content is about to diverge from
        its hash, and de-indexing inside the lock closes the race with a
        concurrent reservation matching it) and return None — write in
        place. Refcount > 1: allocate a fresh block, swap it into the
        lease, release the shared one, and return ``(src, dst)`` for the
        caller's device copy (counted as a CoW copy). Raises when no
        block can be reclaimed — admission should have left headroom."""
        with self._lock:
            blocks = self._leases.get(seq_id)
            if blocks is None:
                raise KeyError(f"sequence {seq_id!r} holds no blocks")
            src = blocks[block_index]
            if self._refcount.get(src, 0) <= 1:
                self._deindex(src)
                return None
            dst = self._take_fresh()
            if dst is None:
                raise RuntimeError(
                    f"copy-on-write for {seq_id!r} found no reclaimable "
                    "block; reservation accounting is broken")
            self._refcount[dst] = 1
            blocks[block_index] = dst
            self.cow_copies += 1
            self._drop(src)
        self._update_gauge()
        return (src, dst)

    # -- prefix index ------------------------------------------------------
    def register_prefix(self, seq_id: str, hashes: Sequence[str]) -> int:
        """Index ``seq_id``'s leading blocks under their chained hashes
        (called once the prompt's K/V is fully materialized). Blocks
        whose hash is already indexed elsewhere — or that are themselves
        already indexed — are skipped; returns how many were newly
        indexed."""
        added = 0
        with self._lock:
            self._tick += 1
            blocks = self._leases.get(seq_id, ())
            for i, h in enumerate(hashes):
                if i >= len(blocks):
                    break
                b = blocks[i]
                if h in self._index or b in self._block_hash:
                    continue
                self._index[h] = b
                self._block_hash[b] = h
                # parent link + depth make the chain walkable from its
                # tail — what resident_chains() advertises fleet-wide
                self._hmeta[h] = {
                    "parent": hashes[i - 1] if i else None,
                    "depth": i + 1, "hits": 0, "last_use": self._tick}
                added += 1
        return added

    def block_refcount(self, block: int) -> int:
        with self._lock:
            return self._refcount.get(block, 0)

    def resident_chains(self, top_k: int = 8) -> List[Dict[str, Any]]:
        """Top-K summary of the resident prefix chains — the replica's
        :class:`~mmlspark_tpu.serve.affinity.PrefixDigest` source.

        A chain is a maximal run of indexed blocks whose WHOLE ancestor
        line is still resident (a chain with an evicted ancestor can
        never be matched by :meth:`try_reserve`, so it is not
        advertised). Each entry carries the tail (deepest) hash, the
        full walkable hash list, the depth in blocks, the tail block's
        live lease count, the chain's hit count, and its last-use tick
        (a monotonic reservation counter, not wall time). Ranked
        hottest-first: (hits, last_use) descending.
        """
        if top_k <= 0:
            return []
        with self._lock:
            resident = set(self._index)
            parents = set()
            for rh in resident:
                hm = self._hmeta.get(rh)
                if hm and hm.get("parent") in resident:
                    parents.add(hm["parent"])
            out: List[Dict[str, Any]] = []
            for tail in resident - parents:
                walk: List[str] = []
                h: Optional[str] = tail
                while h is not None and h in resident:
                    walk.append(h)
                    hm = self._hmeta.get(h)
                    h = hm.get("parent") if hm else None
                if h is not None:
                    continue      # broken chain: an ancestor was evicted
                walk.reverse()
                hm = self._hmeta.get(tail) or {}
                out.append({
                    "chain": tail, "depth": len(walk), "hashes": walk,
                    "leases": self._refcount.get(
                        self._index.get(tail, -1), 0),
                    "hits": int(hm.get("hits", 0)),
                    "last_use": int(hm.get("last_use", 0))})
            out.sort(key=lambda c: (-c["hits"], -c["last_use"],
                                    -c["depth"], c["chain"]))
            return out[:int(top_k)]

    # -- release -----------------------------------------------------------
    def free(self, seq_id: str) -> int:
        """Release ``seq_id``'s shares the moment it finishes (or dies):
        every held block drops one refcount — shared prefix blocks
        survive for their other holders, and refcount-0 indexed blocks
        park in the cached pool instead of the free list. Idempotent (0
        when nothing was held)."""
        with self._lock:
            blocks = self._leases.pop(seq_id, None)
            meta = self._meta.pop(seq_id, None)
            if blocks:
                for b in blocks:
                    self._drop(b)
            if meta and meta.get("pending_cow"):
                self._drop(meta["pending_cow"][0])   # unpin the src
        if not blocks:
            return 0
        self._update_gauge()
        return len(blocks)

    def blocks_for(self, seq_id: str) -> List[int]:
        with self._lock:
            return list(self._leases.get(seq_id, ()))

    def block_table(self, seq_id: str, width: int) -> np.ndarray:
        """``seq_id``'s lease padded to ``width`` with the reserved
        scratch block — one row of the decode program's block-table
        operand."""
        blocks = self.blocks_for(seq_id)
        if len(blocks) > width:
            raise ValueError(
                f"{seq_id!r} holds {len(blocks)} blocks > table width "
                f"{width}")
        row = np.full((width,), RESERVED_BLOCK, np.int32)
        row[:len(blocks)] = blocks
        return row

    @property
    def leasable_blocks(self) -> int:
        """Blocks a sequence can actually hold (excludes scratch)."""
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        """Blocks a reservation can draw on: truly free plus refcount-0
        cached prefix blocks (reclaimed LRU-first on demand)."""
        with self._lock:
            return len(self._free) + len(self._cached)

    @property
    def cached_blocks(self) -> int:
        """Refcount-0 blocks parked with live prefix content."""
        with self._lock:
            return len(self._cached)

    @property
    def used_blocks(self) -> int:
        """Distinct blocks held by at least one sequence (a shared
        prefix block counts once, however many sequences ride it)."""
        with self._lock:
            return len(self._refcount)

    @property
    def active_sequences(self) -> int:
        with self._lock:
            return len(self._leases)

    def occupancy(self) -> float:
        """Held fraction of the leasable arena (the KV-occupancy gauge
        and report column)."""
        return self.used_blocks / max(1, self.leasable_blocks)

    def check_conservation(self) -> bool:
        """Ledger invariant (the property-fuzz assertion): every
        leasable block is in exactly ONE of free / cached / refcounted,
        and the scratch block is in none of them."""
        with self._lock:
            held = set(self._refcount)
            free = set(self._free)
            cached = set(self._cached)
            all_blocks = held | free | cached
            return (len(self._free) + len(self._cached) + len(held)
                    == self.num_blocks - 1
                    and len(all_blocks) == self.num_blocks - 1
                    and RESERVED_BLOCK not in all_blocks
                    and all(self._index.get(h) == b and
                            self._block_hash.get(b) == h
                            for b, h in list(self._cached.items())))

    def stats(self) -> Dict[str, Any]:
        # the resident-chain digest rides the stats dict as a structured
        # (non-numeric) value: the scraper's fleet totals and registry
        # gauges skip it, the affinity layer picks it out by key
        chains = self.resident_chains(
            int(mmlconfig.get("generate.advertise_top_k")))
        with self._lock:
            used = len(self._refcount)
            return {
                "resident_chains": chains,
                # hash-seed params: a digest consumer re-derives the
                # prompt's chain with the SAME (model, dtype, granule)
                # seed, so advertise them next to the chains
                "kv_dtype": self.dtype_name,
                "blocks": self.num_blocks,
                "block_tokens": self.block_tokens,
                "used_blocks": used,
                "free_blocks": len(self._free) + len(self._cached),
                "cached_blocks": len(self._cached),
                "sequences": len(self._leases),
                "occupancy": used / max(1, self.num_blocks - 1),
                "arena_bytes": self.arena_bytes(),
                "unquantized_arena_bytes": self.unquantized_arena_bytes(),
                "quantized": float(self.quantized),
                "prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses,
                "cow_copies": self.cow_copies,
                "prefix_evictions": self.prefix_evictions,
            }

    def _update_gauge(self) -> None:
        if metrics.metrics_enabled():
            metrics.gauge("generate.kv_occupancy").set(self.occupancy())
            metrics.gauge("generate.kv_cached_blocks").set(
                float(self.cached_blocks))
