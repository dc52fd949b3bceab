"""Generative serving lane: continuous batching over a paged KV arena.

The port of ``mmlspark_tpu/serve/generate.py``. The ``/score`` lane
batches REQUESTS; one generation request is hundreds of sequential
single-token steps, so this lane batches SEQUENCES:

- :class:`GenerativeEntry` — the program half. One **prefill** program per
  prompt-length bucket (the served ``TransformerLM``'s own forward at the
  padded bucket, with each block's ``attn_key`` / ``attn_value`` outputs
  written into the arena, so prefill numerics are the served model's, K3
  included where ``supports()`` admits the bucket), ONE single-token
  **decode** program per batch-size bucket (a hand-unrolled forward over
  gathered KV pages, in plain torch as the reference's is plain jnp), the
  **chunk** program (consecutive prompt positions of one sequence over the
  paged history: chunked prefill and the uncached suffix after a prefix
  hit), the **verify** program of speculative decoding (the decode program
  widened to ``spec_tokens + 1`` positions a lane) and the **cow** block
  copy. Every program is built through
  :meth:`GenerativeEntry._compile` — the twin of ``ModelEntry._compile``
  — and :func:`mmlspark_tpu_torch.compile_cache.load_or_compile_program`:
  on a CUDA device one CUDA graph per (kind, bucket), replayed per call
  (``serve/programs.py``). The programs write the arena in place
  (``index_copy_`` / ``index_put_``), so a replay allocates nothing.
- :class:`ContinuousBatcher` — the policy half, pure logic like
  ``MicroBatcher``: sequences JOIN the in-flight batch the step a slot
  frees and LEAVE the step they finish.
- :class:`GenerateLane` — the executor half: a single thread owning the
  arena; each pass advances chunked prefills, admits joiners (prefill +
  first sampled token = TTFT), then runs one bucketed decode step over the
  whole active set.

Admission reserves a sequence's FULL block budget (prompt + max-new) up
front from the :class:`~mmlspark_tpu_torch.serve.kvcache.KVCacheManager`;
when the arena cannot cover it the request sheds with a retryable
``ServerOverloaded``. Sampling (greedy, temperature/top-k) is seeded per
(seed, position), so a restart from the prompt replays the exact token
stream.

Shared-prefix KV reuse (``generate.prefix_cache``, on by default): the
prompt's full blocks are hashed (chained) and already-cached blocks are
shared, so N requests behind one system prompt pay prefill ONCE; only the
uncached suffix runs through the chunk program. A full-prompt hit
schedules a copy-on-write of the final block and recomputes just the last
position for its first token. Chunked prefill (``generate.prefill_chunk``)
splits long prompts into chunks processed one per lane step.

Speculative decoding (``generate.draft_model``): a second registered model
with the same vocab gets its own :class:`GenerativeEntry` and arena. Each
step it proposes ``generate.spec_tokens`` tokens through its own decode
programs, the target checks the whole window in ONE verify replay, and the
host accepts proposals left to right while they equal the target's own
(seeded) sample, so the output is token-identical to plain decode. The
draft reservation is best-effort: a full draft arena only turns
speculation off for that sequence.

int8 KV blocks (``generate.kv_dtype="int8"``): every program quantizes
the rows it writes and dequantizes the rows it gathers
(:func:`~mmlspark_tpu_torch.serve.kvcache.quantize_rows`), inside its
graph.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.observability import events, metrics, spans
from mmlspark_tpu_torch.parallel import collectives
from mmlspark_tpu_torch.parallel.mesh import mesh_shape
from mmlspark_tpu_torch.reliability import watchdog as _watchdog
from mmlspark_tpu_torch.reliability.faults import fault_site
from mmlspark_tpu_torch.serve import programs
from mmlspark_tpu_torch.serve.batcher import bucket_for, default_buckets
from mmlspark_tpu_torch.serve.kvcache import (
    RESERVED_BLOCK, KVCacheManager, blocks_needed, dequantize_rows,
    prefix_block_hashes, quantize_rows,
)
from mmlspark_tpu_torch.utils import config as mmlconfig
from mmlspark_tpu_torch.utils.logging import get_logger

logger = get_logger("serve.generate")

_STOP = object()
_I64 = torch.int64


# ---------------------------------------------------------------------------
# buckets


def parse_prefill_buckets(text: str, max_seq_len: int,
                          block_tokens: int) -> Tuple[int, ...]:
    """``generate.prefill_buckets`` config -> ascending bucket tuple.
    Every bucket must be a multiple of ``block_tokens`` (prefill writes
    whole blocks) and the ladder must cover ``max_seq_len``. "" derives
    powers of two from ``block_tokens`` up to ``max_seq_len``."""
    if text.strip():
        vals = sorted({int(v) for v in text.split(",") if v.strip()})
    else:
        vals, b = [], block_tokens
        while b < max_seq_len:
            vals.append(b)
            b *= 2
        vals.append(b)
    bad = [v for v in vals if v < 1 or v % block_tokens]
    if bad:
        raise ValueError(
            f"prefill buckets must be positive multiples of "
            f"kv_block_tokens={block_tokens}, got {bad}")
    if vals[-1] < max_seq_len:
        raise ValueError(
            f"largest prefill bucket {vals[-1]} < max_seq_len "
            f"{max_seq_len}; the longest admissible prompt would have no "
            "program shape")
    return tuple(vals)


# ---------------------------------------------------------------------------
# sampling — host-side, deterministic per (seed, position) so a restart
# from the prompt replays the identical token stream


def sample_token(logits: np.ndarray, *, temperature: float, top_k: int,
                 seed: int, position: int) -> int:
    """One next-token draw from a (vocab,) logits row. ``temperature <= 0``
    is greedy (pure argmax, no RNG at all); otherwise top-k + temperature
    with an RNG derived from (seed, position) — the same (seed, position)
    always yields the same token regardless of replica or retry."""
    if temperature <= 0:
        return int(np.argmax(logits))
    scaled = logits.astype(np.float64) / float(temperature)
    if top_k > 0 and top_k < scaled.size:
        cutoff = np.partition(scaled, -top_k)[-top_k]
        scaled = np.where(scaled < cutoff, -np.inf, scaled)
    scaled = scaled - scaled.max()
    p = np.exp(scaled)
    p /= p.sum()
    rng = np.random.default_rng((int(seed) & 0x7FFFFFFF, int(position)))
    return int(rng.choice(p.size, p=p))


# ---------------------------------------------------------------------------
# requests and sequences


@dataclass
class GenerateRequest:
    """One admitted generation ask (the ``/generate`` wire shape)."""
    model: str
    prompt: Sequence[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    eos_id: Optional[int] = None
    deadline_ms: Optional[float] = None
    trace_id: str = ""


class _Seq:
    """One in-flight sequence: prompt, sampled tokens, leased blocks, and
    the latency ledger (TTFT + inter-token gaps) its caller is owed."""

    __slots__ = ("seq_id", "prompt", "max_new", "temperature", "top_k",
                 "seed", "eos_id", "future", "trace_id", "enqueued",
                 "deadline", "generated", "ttft_s", "last_t", "itl_s",
                 "finish", "prefill_pos", "hashes", "spec_ok",
                 "spec_proposed", "spec_accepted", "prefix_hits",
                 "draft_hashes")

    def __init__(self, seq_id: str, req: GenerateRequest, future: Future,
                 enqueued: float, deadline: Optional[float]):
        self.seq_id = seq_id
        self.prompt = np.asarray(req.prompt, np.int32).ravel()
        self.max_new = int(req.max_new_tokens)
        self.temperature = float(req.temperature)
        self.top_k = int(req.top_k)
        self.seed = int(req.seed)
        self.eos_id = req.eos_id
        self.future = future
        self.trace_id = req.trace_id
        self.enqueued = enqueued
        self.deadline = deadline
        self.generated: List[int] = []
        self.ttft_s: Optional[float] = None
        self.last_t = enqueued
        self.itl_s: List[float] = []
        self.finish = ""
        self.prefill_pos = 0            # next prompt position to prefill
        self.hashes: List[str] = []     # chained full-block prefix hashes
        self.spec_ok = False            # draft arena reserved: may ride
        self.spec_proposed = 0          # speculation for this sequence
        self.spec_accepted = 0
        self.prefix_hits = 0            # prefix blocks shared at reserve
        self.draft_hashes: List[str] = []  # draft-arena prefix hashes

    @property
    def seq_len(self) -> int:
        return len(self.prompt) + len(self.generated)

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline

    def result(self) -> Dict[str, Any]:
        itl = self.itl_s
        return {
            "tokens": list(self.generated),
            "finish_reason": self.finish,
            "ttft_ms": round((self.ttft_s or 0.0) * 1e3, 3),
            "itl_mean_ms": round(sum(itl) / len(itl) * 1e3, 3) if itl
            else 0.0,
            # prefix blocks shared at admission: what the arena actually
            # re-used for this request
            "prefix_hits": int(self.prefix_hits),
            "trace_id": self.trace_id,
        }


# ---------------------------------------------------------------------------
# continuous batching policy (pure logic, injectable clock, no threads)


class ContinuousBatcher:
    """The continuous-batching sibling of
    :class:`~mmlspark_tpu_torch.serve.batcher.MicroBatcher`, speaking the
    same ``offer``/``ready``/``wait_s``/``take`` vocabulary — with one
    structural difference: ``take`` admits JOINERS into a persistent
    ``active`` set (capped at ``max_sequences``) instead of flushing a
    transient group, and :meth:`leave` retires a finished sequence the same
    step it finishes, freeing its slot for the next waiter. Not
    thread-safe by itself; the lane's single executor thread is the only
    caller."""

    def __init__(self, max_sequences: int,
                 clock: Callable[[], float] = time.monotonic):
        if max_sequences < 1:
            raise ValueError(
                f"max_sequences must be >= 1, got {max_sequences}")
        self.max_sequences = int(max_sequences)
        self.clock = clock
        self._waiting: "deque[_Seq]" = deque()
        self._active: List[_Seq] = []

    def __len__(self) -> int:
        return len(self._waiting)

    @property
    def active(self) -> List[_Seq]:
        return list(self._active)

    @property
    def free_slots(self) -> int:
        return self.max_sequences - len(self._active)

    def offer(self, seq: _Seq) -> None:
        self._waiting.append(seq)

    def ready(self, now: Optional[float] = None) -> bool:
        """A step is due whenever anything is decoding or a waiter can
        join — continuous batching has no coalescing delay to wait out."""
        if self._active:
            return True
        return bool(self._waiting) and self.free_slots > 0

    def wait_s(self, now: Optional[float] = None) -> Optional[float]:
        return 0.0 if self.ready(now) else None

    def take(self, now: Optional[float] = None) -> List[_Seq]:
        """Pop the joiners for THIS step: FIFO waiters up to the free
        slots. The caller prefills each and confirms with :meth:`join`
        (or sheds/expires it without joining)."""
        out: List[_Seq] = []
        while self._waiting and len(self._active) + len(out) \
                < self.max_sequences:
            out.append(self._waiting.popleft())
        return out

    def requeue(self, seq: _Seq) -> None:
        """Put a taken-but-not-admitted waiter back at the FRONT of the
        queue (its slot this step went to a sequence still mid-chunked-
        prefill); it stays first in line for the next step."""
        self._waiting.appendleft(seq)

    def join(self, seq: _Seq) -> None:
        if len(self._active) >= self.max_sequences:
            raise ValueError("active set full; take() admitted too many")
        self._active.append(seq)

    def leave(self, seq: _Seq) -> None:
        self._active.remove(seq)

    def drain(self) -> List[_Seq]:
        """Everything still owned by the batcher (waiting + active), for
        shutdown paths. Leaves the batcher empty."""
        out = list(self._waiting) + list(self._active)
        self._waiting.clear()
        self._active.clear()
        return out


# ---------------------------------------------------------------------------
# programs


class _KVTap:
    """Forward hooks on every block's ``attn_key`` / ``attn_value`` that
    hand the projections to the thread that armed the tap, in block order
    (the counterpart of the reference's ``capture_intermediates`` filter).
    Installed once per entry; unarmed they do nothing, so other forwards
    of the same module (offline scoring, the scoring graphs) are
    untouched."""

    def __init__(self, module: torch.nn.Module, depth: int):
        self._local = threading.local()
        self._handles = []
        for i in range(depth):
            blk = getattr(module, f"block{i}")
            self._handles.append(
                blk.attn_key.register_forward_hook(self._hook("k")))
            self._handles.append(
                blk.attn_value.register_forward_hook(self._hook("v")))

    def _hook(self, kind: str):
        def hook(_module, _inputs, out):
            sink = getattr(self._local, "sink", None)
            if sink is not None:
                sink[kind].append(out)
        return hook

    @contextlib.contextmanager
    def armed(self):
        sink = {"k": [], "v": []}
        self._local.sink = sink
        try:
            yield sink
        finally:
            self._local.sink = None

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []


class GenerativeEntry:
    """The generative artifacts of one registered model: the KV arena plus
    the bucketed prefill / decode / chunk / cow programs.

    :meth:`_compile` is THE generative compile seam — the twin of
    ``ModelEntry._compile`` that tests wrap to assert one program per
    (kind, bucket). Builds are accounted on the UNDERLYING ``ModelEntry``
    (``compile_count``), so registry stats see scoring and generative
    programs in one ledger.
    """

    def __init__(self, entry, *, max_seq_len: Optional[int] = None,
                 max_sequences: Optional[int] = None):
        self.entry = entry
        module = entry.module
        for attr in ("vocab", "dim", "depth", "heads", "max_len"):
            if not hasattr(module, attr):
                raise ValueError(
                    f"model {entry.name!r} ({type(module).__name__}) is "
                    "not a decoder LM; the generative lane serves "
                    "TransformerLM-shaped architectures")
        if any(getattr(getattr(module, f"block{i}"), "has_ffn", False)
               for i in range(module.depth)):
            raise ValueError(
                f"model {entry.name!r} routes its FFN (a MoE LM); the "
                "decode program unrolls the dense MLP blocks only, as the "
                "reference's does")
        # a meshed model decodes on its mesh: every rank runs each program
        # on its shards and its heads of the arena (parallel/leader.py)
        apply = entry.ensure_apply()
        self.placement = getattr(apply, "placement", None)
        self.mesh = None if self.placement is None else self.placement.mesh
        self.device = entry.device
        cap = int(max_seq_len if max_seq_len is not None
                  else mmlconfig.get("generate.max_seq_len"))
        self.max_seq_len = min(cap, int(module.max_len))
        self.max_sequences = int(
            max_sequences if max_sequences is not None
            else mmlconfig.get("generate.max_sequences"))
        split = getattr(module.block0, "_tp", None) is not None
        kv = KVCacheManager.from_config(
            layers=int(module.depth), heads=int(module.heads),
            head_dim=int(module.dim) // int(module.heads),
            dtype=module.dtype, device=self.device, mesh=self.mesh,
            shard_heads=split and bool(mmlconfig.get("generate.shard_kv")))
        self.prefill_buckets = parse_prefill_buckets(
            str(mmlconfig.get("generate.prefill_buckets")),
            self.max_seq_len, kv.block_tokens)
        self.decode_buckets = default_buckets(self.max_sequences)
        self.prefix_cache = bool(mmlconfig.get("generate.prefix_cache"))
        self.prefill_chunk = max(0, int(mmlconfig.get(
            "generate.prefill_chunk")))
        # the chunk program's width: the configured chunk, else one block
        # (the chunk path also serves the uncached-SUFFIX prefill after a
        # prefix hit, so it exists even with chunking nominally off)
        self.chunk_width = min(self.max_seq_len,
                               self.prefill_chunk if self.prefill_chunk > 0
                               else kv.block_tokens)
        self.spec_tokens = max(0, int(mmlconfig.get("generate.spec_tokens")))
        self.spec_width = self.spec_tokens + 1
        self._init_rank(module, kv)
        self._programs: Dict[Tuple[str, int], Callable] = {}
        if self.mesh is not None:
            # this rank's part is this entry; the followers make theirs
            self._gen_key = f"gen{next(_GEN_IDS)}"
            self.placement.extras[self._gen_key] = self
            apply.channel.call(
                "mmlspark_tpu_torch.serve.generate:_gen_open",
                {"key": self.placement.key, "gen": self._gen_key,
                 "cfg": self._rank_cfg()}, n=self.mesh.size())
        # the arena is device memory this model now pins: charge it to the
        # registry entry so the LRU sees params + arena as one tenant (on
        # a mesh this rank's share: 1/|tensor| of a head-sharded arena)
        entry.kv_arena_bytes = self.kv.arena_shard_bytes()

    def _init_rank(self, module, kv) -> None:
        """What every rank of the entry holds: the module, its arena, the
        K/V tap and the paged forward's index constants."""
        self.module = module
        self.kv = kv
        self.vocab = int(module.vocab)
        self.dim = int(module.dim)
        self.depth = int(module.depth)
        self.heads = int(module.heads)
        self.head_dim = self.dim // self.heads
        self.dtype = module.dtype
        self.block_tokens = kv.block_tokens
        # block-table width: every sequence's table is padded to the
        # blocks a max-length sequence needs, so ONE decode program shape
        # serves every occupancy
        self.table_width = blocks_needed(self.max_seq_len,
                                         self.block_tokens)
        # a tensor-split module computes its heads; the arena holds them
        # (head-sharded) or all of them (then each row is gathered over
        # `tensor` before it is stored, and the rank's heads read back)
        self._tp = getattr(module.block0, "_tp", None)
        self._heads_here = self.heads // collectives.size(self._tp)
        self._gather_kv = self._tp is not None \
            and kv.local_heads != self._heads_here
        # index constants of the paged forward, made once outside any
        # capture: key slots of a block table, query columns of a chunk
        self._keys = torch.arange(self.table_width * self.block_tokens,
                                  device=self.device)
        self._cols = torch.arange(max(self.chunk_width, self.spec_width),
                                  device=self.device)
        self._tap = _KVTap(module, self.depth)
        self._fns: Dict[Tuple[str, int], Tuple[Callable, list]] = {}

    def _rank_cfg(self) -> Dict[str, Any]:
        """What a follower needs to make its part of this entry."""
        kv = self.kv
        return {"max_seq_len": self.max_seq_len,
                "chunk_width": self.chunk_width,
                "spec_width": self.spec_width,
                "num_blocks": kv.num_blocks,
                "block_tokens": kv.block_tokens,
                "kv_dtype": kv.dtype_name,
                "shard_heads": bool(kv.arena_sharding)}

    @classmethod
    def _follower(cls, placement, cfg: Dict[str, Any]) -> "GenerativeEntry":
        """A follower's part of a meshed entry: its module's shards, its
        heads of the arena, the same program functions (no ledger use)."""
        self = cls.__new__(cls)
        self.entry = None
        self.placement = placement
        self.mesh = placement.mesh
        self.device = placement.device
        module = placement.module
        self.max_seq_len = cfg["max_seq_len"]
        self.chunk_width = cfg["chunk_width"]
        self.spec_width = cfg["spec_width"]
        kv = KVCacheManager(
            layers=int(module.depth), heads=int(module.heads),
            head_dim=int(module.dim) // int(module.heads),
            num_blocks=cfg["num_blocks"], block_tokens=cfg["block_tokens"],
            dtype=module.dtype, kv_dtype=getattr(torch, cfg["kv_dtype"]),
            device=placement.device, mesh=placement.mesh,
            shard_heads=cfg["shard_heads"])
        self._init_rank(module, kv)
        return self

    def _rank_fn(self, kind: str, bucket: int) -> Tuple[Callable, list]:
        """This rank's function of one (kind, bucket) and its operand
        specs (made once)."""
        key = (kind, int(bucket))
        if key not in self._fns:
            if kind == "prefill":
                self._fns[key] = self._prefill_spec(bucket)
            elif kind == "decode":
                self._fns[key] = self._decode_spec(bucket)
            elif kind == "chunk":
                self._fns[key] = self._chunk_spec(bucket)
            elif kind == "cow":
                self._fns[key] = self._cow_spec()
            elif kind == "verify":
                self._fns[key] = self._verify_spec(bucket)
            else:
                raise ValueError(f"unknown program kind {kind!r}")
        return self._fns[key]

    # -- compile seam ------------------------------------------------------
    def program_for(self, kind: str, bucket: int) -> Callable:
        key = (kind, int(bucket))
        prog = self._programs.get(key)
        if prog is None:
            prog = self._compile(kind, int(bucket))
            self._programs[key] = prog
        return prog

    def built_programs(self) -> Dict[Tuple[str, int], Callable]:
        """(kind, bucket) -> the program built for it."""
        return dict(self._programs)

    def _compile(self, kind: str, bucket: int) -> Callable:
        """Build the program of one (kind, bucket). Every generative build
        funnels through here exactly once per key — the compile-discipline
        tests wrap this method."""
        from mmlspark_tpu_torch import compile_cache
        fn, specs = self._rank_fn(kind, bucket)
        shape_key = (f"{kind}:{bucket}|arena={self.kv.num_blocks}x"
                     f"{self.block_tokens}x{self.heads}x{self.head_dim}"
                     f"|layers={self.depth}|W={self.table_width}"
                     f"|dtype={self.kv.dtype_name}")
        if kind == "verify":
            shape_key += f"|C={self.spec_width}"
        if self.mesh is not None:
            # the placement's identity: the same bucket on another mesh,
            # or on a head-sharded against a whole arena, is another
            # program
            axes = ",".join(f"{a}{n}" for a, n in mesh_shape(
                self.mesh).items() if n > 1) or "1"
            shape_key += (f"|mesh={axes}|kvspec="
                          f"{tuple(self.kv.arena_sharding or ())!r}")

        def fresh():
            if self.mesh is not None:
                return programs.MeshProgram(_GenRun(self, kind, bucket),
                                            specs, self.device, shape_key)
            pool = (self.entry.graph_pool()
                    if self.device.type == "cuda" else None)
            return programs.build(fn, specs, self.device, pool)

        result = compile_cache.load_or_compile_program(
            self.entry.name, self.entry.version, kind, shape_key, fresh)
        self.entry.compile_count += 1
        return result.program

    # -- prefill -----------------------------------------------------------
    def _prefill_spec(self, bucket: int):
        """Prefill for one prompt-length bucket ``Lb``: run the module's OWN
        forward on ``(1, Lb)`` tokens, tap each block's K/V projections,
        write them into the sequence's ``Lb / block_tokens`` arena blocks,
        and return the last live position's logits row (fp32, (vocab,))."""
        module, kv, tap = self.module, self.kv, self._tap
        nb = bucket // self.block_tokens
        shape = (nb, self.block_tokens, kv.local_heads, self.head_dim)

        def prefill(tokens, last_pos, block_ids):
            with torch.no_grad():
                with tap.armed() as sink:
                    hidden = module.forward_hidden(tokens)
                for i in range(self.depth):
                    for name, arena, scales in (
                            ("k", kv.arena_k, kv.scale_k),
                            ("v", kv.arena_v, kv.scale_v)):
                        rows = self._stored(sink[name][i]).reshape(shape)
                        if kv.quantized:
                            rows, sc = quantize_rows(rows)
                            scales[i].index_copy_(0, block_ids, sc)
                        arena[i].index_copy_(0, block_ids,
                                             rows.to(kv.dtype))
                row = hidden.index_select(1, last_pos.view(1))
                return self._logits(row)[0, 0]

        return prefill, [((1, bucket), _I64), ((), _I64), ((nb,), _I64)]

    # -- the paged forward of decode and chunk -----------------------------
    def _paged_forward(self, tokens, positions, tables, n_valid):
        """``(B, C)`` tokens at ``(B, C)`` positions through every block
        over the paged arena, mirroring the module's math one position at
        a time (the reference's decode body, with a chunk's or a verify
        window's ``C`` query rows): each row's K/V is written FIRST so it
        attends itself, then each lane's table gathers its history, masked
        causally at the row's position. Rows at or past a lane's
        ``n_valid`` write the reserved scratch block and their outputs are
        ignored. An int8 arena stores quantized rows and gathers them
        dequantized to the model's dtype. Returns the final-normed fp32
        activations ``(B, C, dim)``."""
        module, kv = self.module, self.kv
        B, C = tokens.shape
        bt, W = self.block_tokens, self.table_width
        heads, hd, dim = self._heads_here, self.head_dim, self.dim
        scale = 1.0 / math.sqrt(hd)
        valid = self._cols[:C][None, :] < n_valid[:, None]           # (B, C)
        # positions past the table or the position table only ever sit in
        # invalid rows; clamp them so no gather leaves its tensor
        cols = torch.clamp(positions // bt, max=W - 1)
        blk_idx = torch.where(valid, torch.gather(tables, 1, cols),
                              RESERVED_BLOCK)
        offs = positions % bt
        masked = self._keys[None, None, :] > positions[:, :, None]   # (B,C,K)
        pos = torch.clamp(positions, max=module.max_len - 1)
        x = module._embed(tokens)
        x = x + module.pos_embedding[0][pos].to(x.dtype)
        for i in range(self.depth):
            blk = getattr(module, f"block{i}")
            y = blk.norm1(x)
            dense = blk._columns if self._tp is not None \
                else (lambda d, h: d(h))
            q = dense(blk.attn_query, y).reshape(B, C, heads, hd)
            k = dense(blk.attn_key, y)
            v = dense(blk.attn_value, y)
            k_all = self._mine(self._write_gather(
                i, kv.arena_k, kv.scale_k, self._stored(k).reshape(
                    B, C, kv.local_heads, hd), blk_idx, offs, tables))
            v_all = self._mine(self._write_gather(
                i, kv.arena_v, kv.scale_v, self._stored(v).reshape(
                    B, C, kv.local_heads, hd), blk_idx, offs, tables))
            s = torch.einsum("bchd,bkhd->bchk", q.float(),
                             k_all.float()) * scale
            s = s.masked_fill(masked[:, :, None, :], float("-inf"))
            p = torch.softmax(s, dim=-1)
            o = torch.einsum("bchk,bkhd->bchd", p.to(v_all.dtype).float(),
                             v_all.float()).to(q.dtype)
            if self._tp is not None:
                x = x + blk._rows(blk.attn_out, o.reshape(B, C, -1))
                y = blk.norm2(x)
                x = x + blk._rows(blk.mlp_down,
                                  _gelu(blk._columns(blk.mlp_up, y)))
            else:
                x = x + blk.attn_out(o.reshape(B, C, dim))
                y = blk.norm2(x)
                x = x + blk.mlp_down(_gelu(blk.mlp_up(y)))
        return module.final_norm(x)

    def _stored(self, rows: torch.Tensor) -> torch.Tensor:
        """A K/V projection ``(..., heads computed here x head_dim)`` as
        the arena stores it: gathered over ``tensor`` when the module
        computes its heads but the arena holds all of them."""
        if not self._gather_kv:
            return rows
        return collectives.all_gather(rows.contiguous(), rows.dim() - 1,
                                      self._tp)

    def _mine(self, rows: torch.Tensor) -> torch.Tensor:
        """The heads this rank computes of a gathered ``(B, K, heads,
        head_dim)`` history (all of them unless the arena is whole under
        a split module)."""
        if not self._gather_kv:
            return rows
        h = self._heads_here
        r = collectives.rank(self._tp)
        return rows[:, :, r * h:(r + 1) * h]

    def _logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """The tied head's fp32 logits, gathered over a vocabulary split
        over ``tensor``."""
        logits = self.module.head(hidden)
        vocab = getattr(self.module, "_vocab", None)
        if vocab is None:
            return logits
        return collectives.all_gather(logits, logits.dim() - 1, vocab)

    def _write_gather(self, layer, arena, scales, rows, blk_idx, offs,
                      tables):
        """Write ``rows`` ``(B, C, heads, head_dim)`` at ``(blk_idx,
        offs)`` of one layer's arena, then gather every lane's table as
        ``(B, W * block_tokens, heads, head_dim)`` in the model's dtype
        (quantized and dequantized through the scale planes when int8)."""
        kv = self.kv
        B = tables.shape[0]
        K = self.table_width * self.block_tokens
        if not kv.quantized:
            arena[layer].index_put_((blk_idx, offs), rows.to(kv.dtype))
            return arena[layer][tables].reshape(B, K, kv.local_heads,
                                                self.head_dim)
        q, sc = quantize_rows(rows)
        arena[layer].index_put_((blk_idx, offs), q)
        scales[layer].index_put_((blk_idx, offs), sc)
        return dequantize_rows(
            arena[layer][tables].reshape(B, K, kv.local_heads,
                                         self.head_dim),
            scales[layer][tables].reshape(B, K)).to(self.dtype)

    def _decode_spec(self, batch: int):
        """Single-token decode for one batch bucket ``B``: operands tokens
        ``(B, 1)``, positions ``(B, 1)``, block tables ``(B, W)`` and
        ``n_valid`` ``(B,)`` (1 for a live lane, 0 for a padding lane);
        returns the next-token logits ``(B, vocab)`` in fp32."""
        module = self.module

        def decode(tokens, positions, tables, n_valid):
            with torch.no_grad():
                xf = self._paged_forward(tokens, positions, tables, n_valid)
                return self._logits(xf)[:, 0]

        W = self.table_width
        return decode, [((batch, 1), _I64), ((batch, 1), _I64),
                        ((batch, W), _I64), ((batch,), _I64)]

    def _chunk_spec(self, C: int):
        """Prefill CHUNK: ``C`` consecutive prompt positions of ONE
        sequence. Serves chunked prefill and the uncached-suffix prefill
        after a prefix hit (earlier shared blocks are only READ). Operands
        tokens ``(1, C)``, positions ``(1, C)``, the table row ``(1, W)``
        and ``n_valid`` ``(1,)``; returns the logits row of the last valid
        position."""
        module = self.module

        def chunk(tokens, positions, table_row, n_valid):
            with torch.no_grad():
                xf = self._paged_forward(tokens, positions, table_row,
                                         n_valid)
                last = torch.clamp(n_valid - 1, min=0)
                return self._logits(xf.index_select(1, last))[0, 0]

        W = self.table_width
        return chunk, [((1, C), _I64), ((1, C), _I64), ((1, W), _I64),
                       ((1,), _I64)]

    def _verify_spec(self, batch: int):
        """Speculative VERIFY for one batch bucket: the decode program
        widened to ``spec_width = spec_tokens + 1`` positions a lane.
        Row ``j`` of a lane's logits is the target's next-token
        distribution after consuming fed token ``j``; lanes feed
        ``n_valid`` in ``[1, C]`` tokens (1 = plain decode riding the same
        program) and rows past it write the reserved scratch block.
        Operands tokens ``(B, C)``, positions ``(B, C)``, tables ``(B,
        W)``, ``n_valid`` ``(B,)``; returns the logits ``(B, C, vocab)`` in
        fp32."""
        module = self.module

        def verify(tokens, positions, tables, n_valid):
            with torch.no_grad():
                xf = self._paged_forward(tokens, positions, tables, n_valid)
                return self._logits(xf)

        W, C = self.table_width, self.spec_width
        return verify, [((batch, C), _I64), ((batch, C), _I64),
                        ((batch, W), _I64), ((batch,), _I64)]

    def _cow_spec(self):
        """Block copy ``src -> dst`` across every layer of both arenas
        (and both scale planes when int8) — the copy-on-write a
        full-prefix-hit joiner owes before it may write its final prompt
        block."""
        kv = self.kv
        planes = [kv.arena_k, kv.arena_v]
        if kv.quantized:
            planes += [kv.scale_k, kv.scale_v]

        def cow(src, dst):
            for arena in planes:
                arena.index_copy_(1, dst.view(1),
                                  arena.index_select(1, src.view(1)))

        return cow, [((), _I64), ((), _I64)]

    def release(self) -> None:
        """Drop programs, the K/V tap and the arena accounting (lane
        shutdown); on a mesh every rank's part."""
        self._programs.clear()
        self._tap.remove()
        self.entry.kv_arena_bytes = 0
        if self.mesh is not None:
            self.placement.extras.pop(self._gen_key, None)
            ch = self.entry.ensure_apply().channel \
                if self.entry.warm else None
            if ch is not None and ch.broken is None \
                    and self.placement.key in ch.placements:
                ch.call("mmlspark_tpu_torch.serve.generate:_gen_close",
                        {"key": self.placement.key, "gen": self._gen_key},
                        n=self.mesh.size())

    def close(self) -> None:
        """A follower's part going with its placement."""
        self._tap.remove()


_GEN_IDS = itertools.count()


class _GenRun:
    """A meshed entry's program call: the padded host operands to every
    rank, each running the entry's function of (kind, bucket) on its
    shards and its heads of the arena; the leader's output returned."""

    meshed = True

    def __init__(self, gen: "GenerativeEntry", kind: str, bucket: int):
        self.gen, self.kind, self.bucket = gen, kind, int(bucket)

    def __call__(self, *operands, prog: Optional[str] = None):
        gen = self.gen
        return gen.entry.ensure_apply().channel.call(
            "mmlspark_tpu_torch.serve.generate:_gen_run",
            {"key": gen.placement.key, "gen": gen._gen_key,
             "kind": self.kind, "bucket": self.bucket, "prog": prog},
            operands, n=gen.mesh.size())

    def rank_launches(self, prog: str) -> list:
        ch = self.gen.entry.ensure_apply().channel
        return ch.rank_launches(self.gen.placement.key, prog)


def _gen_open(ch, header, tensors, local) -> None:
    pl = ch.placements[header["key"]]
    if header["gen"] not in pl.extras:
        pl.extras[header["gen"]] = GenerativeEntry._follower(pl,
                                                             header["cfg"])


def _gen_run(ch, header, tensors, local):
    pl = ch.placements[header["key"]]
    gen = pl.extras[header["gen"]]
    fn, specs = gen._rank_fn(header["kind"], header["bucket"])
    args = [t.to(pl.device, d) for t, (_, d) in zip(tensors, specs)]

    def run():
        with pl.using():
            return fn(*args)
    return pl.counted(header.get("prog"), run)


def _gen_close(ch, header, tensors, local) -> None:
    pl = ch.placements.get(header["key"])
    gen = pl.extras.pop(header["gen"], None) if pl is not None else None
    if gen is not None and gen.entry is None:
        gen.close()


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh approximation."""
    return torch.nn.functional.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# the lane executor


class GenerateLane:
    """Single-threaded decode executor for one generative model.

    Owns the arena and the active set; caller threads only touch the
    admission queue and the (thread-safe) block ledger. ``start=False``
    leaves the thread unstarted so tests drive :meth:`step` directly
    under an injected clock.
    """

    def __init__(self, server, model: str, *, clock=None,
                 start: bool = True):
        self.server = server
        self.model = model
        self.clock = clock if clock is not None else server.clock
        entry = server.registry.get(model)
        self.gen = GenerativeEntry(entry)
        server.registry.touch(entry)
        # speculative decoding: the draft model gets its OWN entry (its
        # own arena + programs) sized to the same sequence envelope, so
        # target and draft block ledgers never interact
        self.draft: Optional[GenerativeEntry] = None
        draft_name = str(mmlconfig.get("generate.draft_model")).strip()
        if draft_name and self.gen.spec_tokens > 0:
            dentry = server.registry.get(draft_name)
            self.draft = GenerativeEntry(
                dentry, max_seq_len=self.gen.max_seq_len,
                max_sequences=self.gen.max_sequences)
            if self.draft.vocab != self.gen.vocab:
                vocab = self.draft.vocab
                self.draft.release()
                self.draft = None
                raise ValueError(
                    f"draft model {draft_name!r} vocab {vocab} != target "
                    f"{model!r} vocab {self.gen.vocab}")
            server.registry.touch(dentry)
        self.batcher = ContinuousBatcher(self.gen.max_sequences,
                                         clock=self.clock)
        self._prefilling: List[_Seq] = []   # joined the arena, mid-chunk
        # deliberately unbounded: backpressure is the KV arena — submit()
        # reserved every enqueued sequence's full block budget, so the
        # queue can never hold more than the arena admits
        self._queue: "queue.Queue" = queue.Queue(maxsize=0)
        self._lock = threading.Lock()
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self._seq_ids = 0
        self._admitted = server._twin("generate.admitted")
        self._shed = server._twin("generate.shed")
        self._expired = server._twin("generate.expired")
        self._completed = server._twin("generate.completed")
        self._failed = server._twin("generate.failed")
        self._prefix_hits = server._twin("generate.prefix_hits")
        self._prefix_misses = server._twin("generate.prefix_misses")
        self._cow_copies = server._twin("generate.cow_copies")
        self._spec_proposed = server._twin("generate.spec_proposed")
        self._spec_accepted = server._twin("generate.spec_accepted")
        self._draft_prefix_hits = server._twin("generate.draft_prefix_hits")
        self.steps = 0          # decode steps taken
        if events.recording_enabled():
            kv = self.gen.kv
            events.emit("decode", "arena", model=self.model,
                        blocks=kv.num_blocks,
                        block_tokens=kv.block_tokens,
                        kv_dtype=kv.dtype_name,
                        arena_bytes=kv.arena_bytes(),
                        unquantized_bytes=kv.unquantized_arena_bytes())
        if start:
            self.start()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run,
            name=f"mmlspark-tpu-torch-generate-{self.model}", daemon=True)
        self._thread.start()

    def close(self, timeout_s: Optional[float] = None) -> None:
        """Stop the executor and fail everything unfinished with
        :class:`ServerClosed` — generation state dies with the lane; a
        caller restarts the sequence from its prompt elsewhere (seeded
        sampling replays the identical tokens). Idempotent."""
        from mmlspark_tpu_torch.serve.server import ServerClosed
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if timeout_s is None:
            timeout_s = float(mmlconfig.get("serving.drain_timeout_s"))
        if self._thread is not None:
            self._queue.put(_STOP)
            self._thread.join(timeout=max(timeout_s, 0.1))
            self._thread = None
        leftovers = [s for s in self._drain_queue() if s is not _STOP]
        leftovers.extend(self.batcher.drain())
        leftovers.extend(self._prefilling)
        self._prefilling.clear()
        for seq in leftovers:
            self._release_blocks(seq)
            if not seq.future.done():
                self._failed.inc()
                seq.future.set_exception(ServerClosed(
                    "server closed mid-generation; restart from prompt "
                    "elsewhere"))
        self.gen.release()
        if self.draft is not None:
            self.draft.release()

    @property
    def closed(self) -> bool:
        return self._closed

    # -- admission (caller threads) ---------------------------------------
    def submit(self, req: GenerateRequest) -> Future:
        from mmlspark_tpu_torch.serve.server import (
            ServerClosed, ServerOverloaded, _mint_trace_id,
        )
        if self._closed:
            raise ServerClosed("generate lane closed")
        prompt = np.asarray(req.prompt, np.int32).ravel()
        if prompt.size < 1:
            raise ValueError("prompt must contain at least one token")
        if prompt.size >= self.gen.max_seq_len:
            raise ValueError(
                f"prompt of {prompt.size} tokens leaves no room under "
                f"generate.max_seq_len={self.gen.max_seq_len}")
        max_new = min(int(req.max_new_tokens),
                      self.gen.max_seq_len - int(prompt.size))
        if max_new < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {req.max_new_tokens}")
        req = GenerateRequest(
            model=req.model, prompt=prompt, max_new_tokens=max_new,
            temperature=req.temperature, top_k=req.top_k, seed=req.seed,
            eos_id=req.eos_id, deadline_ms=req.deadline_ms,
            trace_id=req.trace_id or _mint_trace_id())
        now = self.clock()
        deadline = now + req.deadline_ms / 1e3 if req.deadline_ms else None
        with self._lock:
            if self._closed:
                raise ServerClosed("generate lane closed")
            self._seq_ids += 1
            seq_id = f"{self.model}/s{self._seq_ids}"
        # the whole lifetime's blocks up front: the prefill bucket's span
        # now, the generated tail later — admission is the ONLY place a
        # sequence can fail for memory
        bucket = bucket_for(prompt.size, self.gen.prefill_buckets)
        span_tokens = max(bucket, prompt.size + max_new)
        hashes: List[str] = []
        if self.gen.prefix_cache:
            hashes = prefix_block_hashes(
                self.model, self.gen.kv.dtype_name, prompt,
                self.gen.block_tokens)
        fault_site("generate.enqueue", {"model": self.model,
                                        "prompt": int(prompt.size)})
        blocks = self.gen.kv.try_reserve(
            seq_id, span_tokens, prefix_hashes=hashes,
            prompt_tokens=int(prompt.size))
        if blocks is None:
            self._shed.inc()
            if events.recording_enabled():
                events.emit("generate", "shed", model=self.model,
                            prompt=int(prompt.size), tokens=span_tokens,
                            free_blocks=self.gen.kv.free_blocks,
                            trace_id=req.trace_id)
            raise ServerOverloaded(
                f"KV arena full ({self.gen.kv.free_blocks} free blocks < "
                f"{blocks_needed(span_tokens, self.gen.block_tokens)} "
                "needed); retry with backoff",
                retry_after=float(mmlconfig.get("serving.retry_after_s")))
        seq = _Seq(seq_id, req, Future(), now, deadline)
        seq.future.trace_id = req.trace_id
        seq.hashes = hashes
        info = self.gen.kv.reserve_info(seq_id)
        seq.prefix_hits = int(info["hits"])
        if info["hits"]:
            self._prefix_hits.inc(info["hits"])
        if info["misses"]:
            self._prefix_misses.inc(info["misses"])
        if self.draft is not None:
            # best-effort: a full draft arena only disables speculation
            # for this sequence, it never sheds the request. The draft
            # reservation goes through the SAME prefix-matching admission
            # as the target's, keyed by the draft's own (name, dtype): a
            # repeated prompt skips the draft prefill compute too.
            dhashes: List[str] = []
            if self.draft.prefix_cache:
                dhashes = prefix_block_hashes(
                    self.draft.entry.name, self.draft.kv.dtype_name,
                    prompt, self.draft.block_tokens)
            seq.spec_ok = self.draft.kv.try_reserve(
                seq_id, span_tokens, prefix_hashes=dhashes,
                prompt_tokens=int(prompt.size)) is not None
            if seq.spec_ok:
                seq.draft_hashes = dhashes
                dhits = int(self.draft.kv.reserve_info(seq_id)["hits"])
                if dhits:
                    self._draft_prefix_hits.inc(dhits)
        if hashes and events.recording_enabled():
            events.emit("decode", "prefix", model=self.model,
                        hits=int(info["hits"]), misses=int(info["misses"]),
                        cached_tokens=int(info["cached_tokens"]),
                        cow=bool(info["pending_cow"]),
                        trace_id=req.trace_id)
        self._queue.put(seq)
        self._admitted.inc()
        return seq.future

    # -- executor ----------------------------------------------------------
    def _run(self) -> None:
        hb = _watchdog.register(f"generate.{self.model}")
        try:
            self._run_loop(hb)
        finally:
            hb.close()

    def _run_loop(self, hb) -> None:
        stopping = False
        while True:
            hb.beat()
            busy = self.batcher.ready() or bool(self._prefilling)
            try:
                item = self._queue.get(timeout=0.0 if busy else 0.05)
            except queue.Empty:
                item = None
            if item is _STOP:
                stopping = True
            elif item is not None:
                self.batcher.offer(item)
            for s in self._drain_queue():
                if s is _STOP:
                    stopping = True
                else:
                    self.batcher.offer(s)
            if stopping:
                return              # close() resolves whatever is left
            if self.batcher.ready() or self._prefilling:
                self.step()

    def _drain_queue(self) -> List:
        out: List = []
        while True:
            try:
                out.append(self._queue.get_nowait())
            except queue.Empty:
                return out

    # -- one continuous-batching step (public: tests drive it) ------------
    def step(self) -> None:
        """Advance mid-prefill sequences one chunk, admit joiners
        (prefill + first token), then run ONE decode step over the active
        set — chunked prefill interleaves with decode at exactly this
        boundary. Sequences finishing this step leave and free their
        blocks before the next step's joiners are considered."""
        for s in self._drain_queue():
            if s is not _STOP:
                self.batcher.offer(s)
        for seq in list(self._prefilling):
            self._prefill_chunk_step(seq)
        taken = self.batcher.take()
        room = max(0, self.batcher.free_slots - len(self._prefilling))
        for seq in reversed(taken[room:]):
            self.batcher.requeue(seq)   # slots held by mid-chunk prefills
        for seq in taken[:room]:
            self._admit_one(seq)
        if self.batcher.active:
            if self.draft is not None:
                self._decode_step_spec()
            else:
                self._decode_step()
        if metrics.metrics_enabled():
            metrics.gauge("generate.kv_occupancy").set(
                self.gen.kv.occupancy())

    def _admit_one(self, seq: _Seq) -> None:
        now = self.clock()
        if seq.expired(now):
            from mmlspark_tpu_torch.serve.server import RequestExpired
            self._release_blocks(seq)
            self._expired.inc()
            if events.recording_enabled():
                events.emit("generate", "expired", model=self.model,
                            trace_id=seq.trace_id,
                            waited_ms=round((now - seq.enqueued) * 1e3, 3))
            seq.future.set_exception(RequestExpired(
                "deadline passed before prefill"))
            return
        gen = self.gen
        Lp = int(seq.prompt.size)
        info = gen.kv.reserve_info(seq.seq_id)
        cached = min(int(info["cached_tokens"]), Lp)
        cow = gen.kv.take_pending_cow(seq.seq_id)
        if cow is not None:
            # full-prefix hit: copy the final shared block into this
            # sequence's owned block BEFORE its first (re)write
            try:
                self._cow_copy(gen, cow)
            except Exception as e:
                logger.error("cow copy failed for %s: %s", seq.seq_id, e)
                self._fail_seq(seq, e)
                return
            gen.kv.cow_done(seq.seq_id)
            self._cow_copies.inc()
            if events.recording_enabled():
                events.emit("decode", "cow", model=self.model,
                            src=cow[0], dst=cow[1], trace_id=seq.trace_id)
        # the whole-prompt prefill writes EVERY leading block, so any
        # reservation that shares cached blocks must take the chunk path
        # (it only writes from the first uncached position)
        use_chunk = cached > 0 or (gen.prefill_chunk > 0
                                   and Lp > gen.chunk_width)
        if not use_chunk:
            try:
                self._prefill(seq)
            except Exception as e:
                logger.error("prefill failed for %s: %s", seq.seq_id, e)
                self._fail_seq(seq, e)
                return
            self.batcher.join(seq)
            if seq.finish:          # eos / budget hit on the first token
                self._finish(seq)
            return
        # chunk path: compute only the uncached suffix, one chunk per
        # lane step; a FULL hit recomputes just the last prompt position
        # (into the CoW'd block) to sample its first token
        seq.prefill_pos = cached if cached < Lp else max(Lp - 1, 0)
        self._prefilling.append(seq)
        self._prefill_chunk_step(seq)

    def _prefill(self, seq: _Seq) -> None:
        gen = self.gen
        Lp = int(seq.prompt.size)
        bucket = bucket_for(Lp, gen.prefill_buckets)
        nb = bucket // gen.block_tokens
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :Lp] = seq.prompt
        block_ids = np.asarray(gen.kv.blocks_for(seq.seq_id)[:nb], np.int64)
        program = gen.program_for("prefill", bucket)
        fault_site("generate.prefill", {"model": self.model,
                                        "bucket": bucket})
        t0 = self.clock()
        with spans.span("decode", "prefill", model=self.model,
                        bucket=bucket):
            logits = np.asarray(program(tokens, np.int64(Lp - 1), block_ids,
                                        fetch="generate.prefill"),
                                np.float32)
        if seq.hashes:
            gen.kv.register_prefix(seq.seq_id, seq.hashes)
        self._draft_prefill(seq)
        self._first_token(seq, logits, t0, bucket=bucket)

    def _first_token(self, seq: _Seq, logits: np.ndarray, t0: float,
                     **fields) -> None:
        """Sample the first token from the prompt's last logits row: the
        sequence's time to first token."""
        now = self.clock()
        self._append_token(seq, logits, position=int(seq.prompt.size))
        seq.ttft_s = now - seq.enqueued
        seq.last_t = now
        if metrics.metrics_enabled():
            metrics.histogram("generate.ttft_ms").observe(
                seq.ttft_s * 1e3, exemplar=seq.trace_id)
        if events.recording_enabled():
            events.emit("decode", "prefill", model=self.model,
                        prompt=int(seq.prompt.size),
                        prefill_ms=round((now - t0) * 1e3, 3),
                        trace_id=seq.trace_id, **fields)

    def _cow_copy(self, entry: GenerativeEntry,
                  pair: Tuple[int, int]) -> None:
        entry.program_for("cow", 0)(np.int64(pair[0]), np.int64(pair[1]))

    def _release_blocks(self, seq: _Seq) -> None:
        """Free every block lease the sequence holds: the target arena
        and, when speculation reserved one, the draft arena (both
        idempotent)."""
        self.gen.kv.free(seq.seq_id)
        if self.draft is not None:
            self.draft.kv.free(seq.seq_id)

    def _fail_seq(self, seq: _Seq, exc: Exception) -> None:
        self._release_blocks(seq)
        self._failed.inc()
        if not seq.future.done():
            seq.future.set_exception(exc)

    # -- chunked / suffix prefill ------------------------------------------
    def _prefill_chunk_step(self, seq: _Seq) -> None:
        """One chunk of ``seq``'s remaining prompt through the chunk
        program. On the final chunk the sequence samples its first token
        (TTFT), registers its prefix blocks, and joins the active set."""
        gen = self.gen
        Lp = int(seq.prompt.size)
        C = gen.chunk_width
        start = seq.prefill_pos
        n_valid = min(C, Lp - start)
        final = start + n_valid >= Lp
        tokens = np.zeros((1, C), np.int32)
        tokens[0, :n_valid] = seq.prompt[start:start + n_valid]
        positions = (start + np.arange(C)).astype(np.int64)[None]
        table_row = gen.kv.block_table(seq.seq_id, gen.table_width)[None]
        program = gen.program_for("chunk", C)
        fault_site("generate.prefill", {"model": self.model, "bucket": C,
                                        "start": start})
        t0 = self.clock()
        try:
            with spans.span("decode", "prefill_chunk", model=self.model,
                            chunk=C, start=start):
                row = program(tokens, positions, table_row,
                              np.asarray([n_valid], np.int64),
                              fetch="generate.prefill" if final else None)
        except Exception as e:
            logger.error("chunk prefill failed for %s: %s", seq.seq_id, e)
            if seq in self._prefilling:
                self._prefilling.remove(seq)
            self._fail_seq(seq, e)
            return
        seq.prefill_pos = start + n_valid
        if not final:
            return
        self._prefilling.remove(seq)
        if seq.hashes:
            gen.kv.register_prefix(seq.seq_id, seq.hashes)
        self._draft_prefill(seq)
        self._first_token(seq, np.asarray(row, np.float32), t0, bucket=C,
                          chunked=True,
                          cached_tokens=seq.prefix_hits * gen.block_tokens)
        self.batcher.join(seq)
        if seq.finish:              # eos / budget hit on the first token
            self._finish(seq)

    # -- speculative decoding ----------------------------------------------
    def _draft_prefill(self, seq: _Seq) -> None:
        """Materialize the draft model's KV for the prompt. Failure only
        degrades the sequence to non-speculative decode.

        Mirrors the target's prefix-reuse admission: cached leading blocks
        (shared via the draft ledger's prefix chain) are not recomputed —
        only the uncached suffix runs, through the draft's chunk program,
        and a pending copy-on-write resolves before the first write. The
        whole-prompt prefill writes EVERY leading block, so any
        reservation with cached blocks takes the suffix path."""
        if self.draft is None or not seq.spec_ok:
            return
        d = self.draft
        try:
            Lp = int(seq.prompt.size)
            info = d.kv.reserve_info(seq.seq_id)
            cached = min(int(info["cached_tokens"]), Lp)
            cow = d.kv.take_pending_cow(seq.seq_id)
            if cow is not None:
                self._cow_copy(d, cow)
                d.kv.cow_done(seq.seq_id)
            if cached > 0:
                # suffix-only: recompute from the first uncached
                # position (a FULL hit redoes just the last one)
                C = d.chunk_width
                start = min(cached, Lp - 1)
                while start < Lp:
                    n_valid = min(C, Lp - start)
                    tokens = np.zeros((1, C), np.int32)
                    tokens[0, :n_valid] = seq.prompt[start:start + n_valid]
                    positions = (start + np.arange(C)).astype(np.int64)[None]
                    table_row = d.kv.block_table(seq.seq_id,
                                                 d.table_width)[None]
                    d.program_for("chunk", C)(
                        tokens, positions, table_row,
                        np.asarray([n_valid], np.int64))
                    start += n_valid
            else:
                bucket = bucket_for(Lp, d.prefill_buckets)
                nb = bucket // d.block_tokens
                tokens = np.zeros((1, bucket), np.int32)
                tokens[0, :Lp] = seq.prompt
                block_ids = np.asarray(d.kv.blocks_for(seq.seq_id)[:nb],
                                       np.int64)
                d.program_for("prefill", bucket)(
                    tokens, np.int64(Lp - 1), block_ids)
            if seq.draft_hashes:
                d.kv.register_prefix(seq.seq_id, seq.draft_hashes)
        except Exception as e:
            logger.warning("draft prefill failed for %s (speculation off "
                           "for this sequence): %s", seq.seq_id, e)
            d.kv.free(seq.seq_id)
            seq.spec_ok = False

    def _draft_propose(self, active: List[_Seq], fed: np.ndarray,
                       drafts: np.ndarray) -> None:
        """Run the draft model ``max(fed) - 1`` single-token decode steps
        over the spec-riding lanes, sampling each proposal with the SAME
        per-(seed, position) sampler the target uses — so a correct draft
        matches the target's token exactly, in greedy and seeded-sampling
        modes. Lanes whose window is exhausted ride as padding lanes
        (scratch-block writes)."""
        d = self.draft
        B = bucket_for(len(active), d.decode_buckets)
        W = d.table_width
        prev = np.array([seq.generated[-1] for seq in active], np.int64)
        for j in range(drafts.shape[1]):
            lanes = [i for i in range(len(active)) if j < int(fed[i]) - 1]
            if not lanes:
                return
            tokens = np.zeros((B, 1), np.int32)
            positions = np.zeros((B, 1), np.int64)
            tables = np.full((B, W), RESERVED_BLOCK, np.int64)
            n_valid = np.zeros((B,), np.int64)
            for i in lanes:
                seq = active[i]
                tokens[i, 0] = prev[i]
                positions[i, 0] = seq.seq_len - 1 + j
                tables[i] = d.kv.block_table(seq.seq_id, W)
                n_valid[i] = 1
            rows = np.asarray(d.program_for("decode", B)(
                tokens, positions, tables, n_valid, fetch="generate.draft"),
                np.float32)
            for i in lanes:
                seq = active[i]
                tok = sample_token(rows[i], temperature=seq.temperature,
                                   top_k=seq.top_k, seed=seq.seed,
                                   position=seq.seq_len + j)
                drafts[i, j] = tok
                prev[i] = tok

    def _decode_step_spec(self) -> None:
        """One speculative step: the draft proposes up to ``spec_tokens``
        tokens a lane, the target checks the whole window in ONE verify
        replay, and each lane accepts proposals left to right while they
        match what the target's own sampler emits — so the output stream
        is token-identical to plain decode, at up to ``spec_width`` tokens
        a target step. Lanes that cannot speculate (draft arena full,
        window exhausted) ride the same program with a one-token window."""
        gen = self.gen
        active = self.batcher.active
        B = bucket_for(len(active), gen.decode_buckets)
        C = gen.spec_width
        W = gen.table_width
        fed = np.ones((len(active),), np.int64)
        for i, seq in enumerate(active):
            remaining = seq.max_new - len(seq.generated)
            if seq.spec_ok and remaining > 1:
                fed[i] = min(C, remaining)
        gamma = int(fed.max()) - 1
        drafts = np.zeros((len(active), max(gamma, 0)), np.int64)
        if gamma > 0:
            self._draft_propose(active, fed, drafts)
        tokens = np.zeros((B, C), np.int32)
        positions = np.zeros((B, C), np.int64)
        tables = np.full((B, W), RESERVED_BLOCK, np.int64)
        n_valid = np.zeros((B,), np.int64)
        for i, seq in enumerate(active):
            f = int(fed[i])
            tokens[i, 0] = seq.generated[-1]
            tokens[i, 1:f] = drafts[i, :f - 1]
            positions[i] = seq.seq_len - 1 + np.arange(C)
            tables[i] = gen.kv.block_table(seq.seq_id, W)
            n_valid[i] = f
        program = gen.program_for("verify", B)
        fault_site("generate.step", {"model": self.model, "batch": B,
                                     "active": len(active)})
        t0 = self.clock()
        with spans.span("decode", "step", model=self.model, batch=B,
                        active=len(active), spec=True):
            rows = np.asarray(program(tokens, positions, tables, n_valid,
                                      fetch="generate.step"), np.float32)
        now = self.clock()
        self.steps += 1
        hot = metrics.metrics_enabled()
        emitted = 0
        for i, seq in enumerate(active):
            f = int(fed[i])
            appended = 0
            matched = 0
            for j in range(f):
                self._append_token(seq, rows[i, j], position=seq.seq_len)
                appended += 1
                if seq.finish:
                    break
                if j < f - 1:
                    if seq.generated[-1] != int(drafts[i, j]):
                        break       # divergence: the window past j is junk
                    matched += 1
            if f > 1:
                seq.spec_proposed += f - 1
                seq.spec_accepted += matched
                self._spec_proposed.inc(f - 1)
                self._spec_accepted.inc(matched)
            emitted += appended
            gap = (now - seq.last_t) / appended
            seq.last_t = now
            seq.itl_s.extend([gap] * appended)
            if hot:
                metrics.histogram("generate.itl_ms").observe(
                    gap * 1e3, exemplar=seq.trace_id)
            if not seq.finish and seq.expired(now):
                seq.finish = "deadline"
            if seq.finish:
                self._finish(seq)
        if events.recording_enabled():
            events.emit("decode", "step", model=self.model, batch=B,
                        active=len(active), tokens=emitted, spec=True,
                        step_ms=round((now - t0) * 1e3, 3))

    def _decode_step(self) -> None:
        gen = self.gen
        active = self.batcher.active
        bucket = bucket_for(len(active), gen.decode_buckets)
        W = gen.table_width
        tokens = np.zeros((bucket, 1), np.int32)
        positions = np.zeros((bucket, 1), np.int64)
        tables = np.full((bucket, W), RESERVED_BLOCK, np.int64)
        n_valid = np.zeros((bucket,), np.int64)
        for i, seq in enumerate(active):
            tokens[i, 0] = seq.generated[-1]
            positions[i, 0] = seq.seq_len - 1   # the fed token's position
            tables[i] = gen.kv.block_table(seq.seq_id, W)
            n_valid[i] = 1
        program = gen.program_for("decode", bucket)
        fault_site("generate.step", {"model": self.model, "batch": bucket,
                                     "active": len(active)})
        t0 = self.clock()
        with spans.span("decode", "step", model=self.model, batch=bucket,
                        active=len(active)):
            rows = np.asarray(program(tokens, positions, tables, n_valid,
                                      fetch="generate.step"), np.float32)
        now = self.clock()
        self.steps += 1
        hot = metrics.metrics_enabled()
        for i, seq in enumerate(active):
            self._append_token(seq, rows[i], position=seq.seq_len)
            gap = now - seq.last_t
            seq.last_t = now
            seq.itl_s.append(gap)
            if hot:
                metrics.histogram("generate.itl_ms").observe(
                    gap * 1e3, exemplar=seq.trace_id)
            if not seq.finish and seq.expired(now):
                seq.finish = "deadline"     # partial result, not an error
            if seq.finish:
                self._finish(seq)
        if events.recording_enabled():
            events.emit("decode", "step", model=self.model, batch=bucket,
                        active=len(active),
                        step_ms=round((now - t0) * 1e3, 3))

    def _append_token(self, seq: _Seq, logits: np.ndarray,
                      position: int) -> None:
        tok = sample_token(logits, temperature=seq.temperature,
                           top_k=seq.top_k, seed=seq.seed,
                           position=position)
        seq.generated.append(tok)
        if seq.eos_id is not None and tok == seq.eos_id:
            seq.finish = "stop"
        elif len(seq.generated) >= seq.max_new:
            seq.finish = seq.finish or "length"

    def _finish(self, seq: _Seq) -> None:
        self.batcher.leave(seq)
        freed = self.gen.kv.free(seq.seq_id)
        if self.draft is not None:
            self.draft.kv.free(seq.seq_id)
        self._completed.inc()
        now = self.clock()
        if events.recording_enabled():
            itl = seq.itl_s
            events.emit("generate", "request", model=self.model,
                        prompt=int(seq.prompt.size),
                        tokens=len(seq.generated), finish=seq.finish,
                        ttft_ms=round((seq.ttft_s or 0.0) * 1e3, 3),
                        itl_mean_ms=round(sum(itl) / len(itl) * 1e3, 3)
                        if itl else 0.0,
                        itl_max_ms=round(max(itl) * 1e3, 3) if itl
                        else 0.0,
                        total_ms=round((now - seq.enqueued) * 1e3, 3),
                        kv_occupancy=round(self.gen.kv.occupancy(), 4),
                        prefix_hits=seq.prefix_hits,
                        spec_proposed=seq.spec_proposed,
                        spec_accepted=seq.spec_accepted,
                        trace_id=seq.trace_id)
            events.emit("decode", "evict", model=self.model,
                        blocks=freed, trace_id=seq.trace_id)
        seq.future.set_result(seq.result())

    # -- introspection -----------------------------------------------------
    def stats(self) -> Dict[str, float]:
        s = {"admitted": self._admitted.value,
             "shed": self._shed.value,
             "expired": self._expired.value,
             "completed": self._completed.value,
             "failed": self._failed.value,
             "waiting": len(self.batcher),
             "active": len(self.batcher.active),
             "prefilling": len(self._prefilling),
             "prefix_hits": self._prefix_hits.value,
             "prefix_misses": self._prefix_misses.value,
             "cow_copies": self._cow_copies.value,
             "spec_proposed": self._spec_proposed.value,
             "spec_accepted": self._spec_accepted.value,
             "steps": self.steps}
        s.update({f"kv.{k}": v for k, v in self.gen.kv.stats().items()})
        if self.draft is not None:
            s["draft.kv.used_blocks"] = self.draft.kv.used_blocks
            s["draft.kv.free_blocks"] = self.draft.kv.free_blocks
            s["draft_prefix_hits"] = self._draft_prefix_hits.value
        return s
