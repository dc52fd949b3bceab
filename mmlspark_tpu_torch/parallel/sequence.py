"""Attention over one device, over a ring of ranks, and by all-to-all.

The port of ``mmlspark_tpu/parallel/sequence.py``:

- :func:`full_attention` is the ``attention_fn`` every decoder block
  calls, on (B, L, H, D). On a CUDA tensor whose shape
  :func:`ops.attention.supports` admits, ``use_flash="auto"`` runs K3
  (``ops/attention.py``); everything else (CPU tensors, ragged lengths)
  takes the reference path, as the JAX package does on its CPU backend.
- **Ring attention** (:func:`ring_attention`): each rank of the ``seq``
  axis holds its slice of the sequence; Q stays, and the K/V blocks
  travel round the ring (:func:`collectives.shift`, the port's
  ``ppermute``) while each rank folds them into its queries' online
  softmax, with fp32 accumulators and the reference's ``-inf`` guards.
  Plain torch, as the reference's ``jnp`` body: no kernel runs here. The
  backward is autograd's, the shift's transpose being the reverse shift.
- **Ulysses** (:func:`ulysses_attention`): one all-to-all swaps the split
  from the sequence to the heads (:func:`collectives.exchange`), each rank
  runs :func:`full_attention` (K3 on the card) over the whole sequence for
  its share of the heads, and a second all-to-all swaps back. Needs the
  local head count divisible by the ``seq`` size.

A block split over ``tensor`` hands these functions its local heads only
(``models/zoo/transformer.py``), so a tensor x seq mesh keeps the heads
split through attention, as the reference's ``_qkv_spec`` does.
"""
from __future__ import annotations

import math
from functools import partial

import torch

from mmlspark_tpu_torch.ops import attention as _attention
from mmlspark_tpu_torch.parallel import collectives


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True,
                   use_flash: str = "auto") -> torch.Tensor:
    """Single-device attention (B, L, H, D).

    ``use_flash``: "auto" (K3 on a CUDA tensor that ``supports()`` admits)
    or "never" (the reference path, which the parity checks use). The
    reference: scores in fp32, a -inf causal mask, the softmax in fp32,
    the probabilities cast to v's dtype before the second product (so does
    K3's bf16 tensor-core route; its f32 CUDA-core route keeps them fp32),
    the result cast to q's dtype."""
    if use_flash == "auto" and q.device.type == "cuda" \
            and _attention.supports(q.shape):
        return _attention.flash_attention(q, k, v, causal=causal)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("blhd,bkhd->bhlk", q.float(), k.float()) * scale
    if causal:
        L, K = s.shape[-2], s.shape[-1]
        mask = (torch.arange(K, device=q.device)[None, :]
                > torch.arange(L, device=q.device)[:, None])
        s = s.masked_fill(mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhlk,bkhd->blhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _seq_group(mesh, seq_axis: str):
    from mmlspark_tpu_torch.parallel.sharding import axis_group
    return axis_group(mesh, (seq_axis,))


def _ring_attention_local(q, k, v, group, causal: bool) -> torch.Tensor:
    """One rank's body: its queries against every rank's K/V block, the
    blocks arriving one ring step at a time (online softmax)."""
    size = collectives.size(group)
    me = collectives.rank(group)
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    q_pos = me * Lq + torch.arange(Lq, device=dev)
    qf = q.float()
    # accumulators in fp32 (bf16 rounding would compound over the ring);
    # k/v travel in the input dtype
    o = torch.zeros((B, H, Lq, D), dtype=torch.float32, device=dev)
    m = torch.full((B, H, Lq), float("-inf"), dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, H, Lq), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(size):
        owner = (me - i) % size                  # whose block is here
        s = torch.einsum("blhd,bkhd->bhlk", qf, k.float()) * scale
        if causal:
            k_pos = owner * Lk + torch.arange(Lk, device=dev)
            mask = k_pos[None, :] > q_pos[:, None]
            s = torch.where(mask[None, None], float("-inf"), s)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # exp(-inf - -inf) guard: fully masked rows keep m=-inf, p=0
        m_safe = torch.where(torch.isinf(m_new), zero, m_new)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(torch.isinf(s), zero, p)
        corr = torch.exp(torch.where(torch.isinf(m), zero, m) - m_safe)
        corr = torch.where(torch.isinf(m), zero, corr)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum(
            "bhlk,bkhd->bhld", p.to(v.dtype).float(), v.float())
        m = m_new
        if i + 1 < size:
            k = collectives.shift(k, group, 1)
            v = collectives.shift(v, group, 1)
    out = o / torch.clamp(l, min=1e-30)[..., None]        # (B, H, Lq, D)
    return out.to(q.dtype).permute(0, 2, 1, 3)            # (B, Lq, H, D)


def _qkv_spec(mesh, seq_axis: str, n_heads: int):
    """The reference's (B, L, H, D) spec: batch over the data axes, L over
    ``seq_axis`` and, when the head count divides, H over ``tensor``."""
    from mmlspark_tpu_torch.parallel.mesh import mesh_shape
    from mmlspark_tpu_torch.parallel.sharding import active_batch_axes
    t = mesh_shape(mesh).get("tensor", 1)
    head = "tensor" if t > 1 and n_heads % t == 0 else None
    return (active_batch_axes(mesh), seq_axis, head, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, seq_axis: str = "seq",
                   causal: bool = True) -> torch.Tensor:
    """Context-parallel attention on this rank's (B, L/s, H, D) slices of
    a sequence split over ``seq_axis``; full attention when it is of size
    1."""
    group = _seq_group(mesh, seq_axis)
    if collectives.size(group) == 1:
        return full_attention(q, k, v, causal)
    return _ring_attention_local(q, k, v, group, causal)


def _ulysses_local(q, k, v, group, causal: bool) -> torch.Tensor:
    s = collectives.size(group)
    B, Lq, H, D = q.shape

    def to_heads(x):
        # (B, L/s, H, D) -> (s, B, L/s, H/s, D): chunk j (head group j)
        # goes to rank j, which sends back its slice of the sequence
        x = x.reshape(B, Lq, s, H // s, D).permute(2, 0, 1, 3, 4)
        x = collectives.exchange(x.contiguous(), group)
        return x.permute(1, 0, 2, 3, 4).reshape(B, s * Lq, H // s, D)

    o = full_attention(to_heads(q), to_heads(k), to_heads(v), causal)
    # back: (B, L, H/s, D) -> (s, B, L/s, H/s, D) -> (B, L/s, H, D)
    o = o.reshape(B, s, Lq, H // s, D).permute(1, 0, 2, 3, 4)
    o = collectives.exchange(o.contiguous(), group)
    return o.permute(1, 2, 0, 3, 4).reshape(B, Lq, H, D)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, seq_axis: str = "seq",
                      causal: bool = True) -> torch.Tensor:
    """All-to-all sequence parallelism (the DeepSpeed-Ulysses pattern) on
    this rank's (B, L/s, H_local, D) slices; needs ``H_local`` (the heads
    this rank holds, after any ``tensor`` split) divisible by the ``seq``
    size."""
    group = _seq_group(mesh, seq_axis)
    s = collectives.size(group)
    if s == 1:
        return full_attention(q, k, v, causal)
    if q.shape[2] % s:
        raise ValueError(
            f"ulysses needs per-shard heads ({q.shape[2]}) divisible by "
            f"|{seq_axis}|={s}")
    return _ulysses_local(q, k, v, group, causal)


def make_attention_fn(mesh=None, impl: str = "auto",
                      seq_axis: str = "seq"):
    """``attention_fn`` factory for ``TransformerLM``: "full" | "ring" |
    "ulysses" | "auto" (ring when the mesh has a ``seq`` axis of more than
    one rank, else full). The sequence-parallel functions carry
    ``seq_parallel = seq_axis``, which the LM checks before it trains on
    a split sequence."""
    if impl == "auto":
        from mmlspark_tpu_torch.parallel.mesh import mesh_shape
        impl = ("ring" if mesh is not None
                and mesh_shape(mesh).get(seq_axis, 1) > 1 else "full")
    if impl == "full":
        return full_attention
    if impl in ("ring", "ulysses"):
        fn = partial(ring_attention if impl == "ring" else ulysses_attention,
                     mesh=mesh, seq_axis=seq_axis)
        fn.seq_parallel = seq_axis
        return fn
    raise ValueError(f"unknown attention impl {impl!r}")
