"""Flash attention: K3, its plain version, and its plain-torch backward.

The port of ``mmlspark_tpu/ops/pallas_attention.py``. There the forward was
a Pallas TPU kernel; here it is one of two CUDA kernels written by hand for
Hopper, behind :func:`flash_attention`:

- a CUDA tensor launches the kernel :func:`_route` names from its dtype and
  head dim alone, or raises for a dtype, shape or layout that kernel does
  not take (there is no fallback, from one route to the other or to the
  plain version):
  - "tc", bf16 with D <= 128: ``kernels/csrc/flash_attention_wgmma.cu``,
    wgmma on the tensor cores with TMA-fed K/V tiles; it rounds the
    probabilities to bf16 before p.v, as the reference path does;
  - "f32", f32 and bf16 with D > 128: ``kernels/csrc/flash_attention.cu``,
    the JAX kernel's fp32 arithmetic on the CUDA cores;
- a CPU tensor takes :func:`flash_attention_plain`, the JAX kernel's
  algorithm in plain torch (fp32 online softmax over key blocks of 256,
  masked with -1e30, the causal loop cut at the query block).

The backward is :func:`_flash_backward_plain`, a plain-torch port of the
JAX package's ``_flash_bwd_impl``, which is plain jnp there too: a row
log-sum-exp pass, then ``D_i = rowsum(dO * O)`` and blockwise dq, dk, dv.

Layout (B, L, H, D), as every attention function of the package takes it.
:func:`supports` is the JAX package's gate, unchanged, so both packages
route the same shapes to the fused kernel.
"""
from __future__ import annotations

import math

import torch

from mmlspark_tpu_torch.kernels import FLASH_ATTENTION, FLASH_ATTENTION_TC

_NEG_INF = -1e30
BLOCK_Q = 256
BLOCK_K = 256
# the JAX package's VMEM budget for K/V of one (batch, head): L * d elements
_VMEM_KV_LIMIT = 1 << 20


def supports(q_shape) -> bool:
    """Whether the fused kernel applies: block-divisible length of at least
    two query blocks, a head dim that is a multiple of 8, and L * d within
    the JAX package's budget (``pallas_attention.py:136-142``)."""
    _, L, _, d = q_shape
    return L % BLOCK_Q == 0 and L % BLOCK_K == 0 and L >= 2 * BLOCK_Q \
        and d % 8 == 0 and L * d <= _VMEM_KV_LIMIT


def _scale(d: int) -> float:
    """1/sqrt(d) in double, as the JAX kernel takes it; multiplied into
    fp32 it rounds to the same fp32 factor on every route."""
    return 1.0 / math.sqrt(d)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False) -> torch.Tensor:
    """The JAX kernel's algorithm (``_flash_kernel``) in plain torch:
    q cast to fp32 and scaled, per query block an online max and sum in
    fp32 over key blocks, masked with -1e30 and, when causal, stopped at
    the query block; ``acc / max(l, 1e-30)`` cast to q's dtype."""
    b, L, h, d = q.shape
    block_q, block_k = BLOCK_Q, BLOCK_K
    qf = (q.float() * _scale(d)).permute(0, 2, 1, 3)         # (b, h, L, d)
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    out = torch.empty((b, h, L, d), dtype=q.dtype, device=q.device)
    n_q = -(-L // block_q)
    for qi in range(n_q):
        qb = qf[:, :, qi * block_q:(qi + 1) * block_q]
        bq = qb.shape[2]
        q_idx = qi * block_q + torch.arange(bq, device=q.device)[:, None]
        m = torch.full((b, h, bq, 1), _NEG_INF, device=q.device)
        l = torch.zeros((b, h, bq, 1), device=q.device)
        acc = torch.zeros((b, h, bq, d), device=q.device)
        n_blocks = -(-L // block_k)
        if causal:
            n_blocks = min(n_blocks, ((qi + 1) * block_q + block_k - 1)
                           // block_k)
        for i in range(n_blocks):
            kb = kf[:, :, i * block_k:(i + 1) * block_k]
            vb = vf[:, :, i * block_k:(i + 1) * block_k]
            s = qb @ kb.transpose(-1, -2)                        # (b,h,bq,bk)
            if causal:
                k_idx = i * block_k + torch.arange(kb.shape[2],
                                                   device=q.device)[None, :]
                s = torch.where(k_idx <= q_idx, s,
                                torch.full_like(s, _NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + p @ vb
            m = m_new
        out[:, :, qi * block_q:qi * block_q + bq] = (
            acc / torch.clamp(l, min=1e-30)).to(q.dtype)
    return out.permute(0, 2, 1, 3).contiguous()


def _route(dtype: torch.dtype, d: int) -> str:
    """Which K3 kernel a CUDA tensor launches: "tc" (tensor cores) for bf16
    with a head dim up to 128, "f32" (the CUDA-core kernel, the only one
    that holds the plain version's fp32 arithmetic to 2e-5) otherwise."""
    return "tc" if dtype == torch.bfloat16 and d <= 128 else "f32"


def _tma_ready(t: torch.Tensor) -> bool:
    """Whether TMA can read ``t`` in place: a 16-byte-aligned base and
    (b, l, h) strides of 16-byte multiples (a dim of size 1 never steps)."""
    step = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        n == 1 or s % step == 0 for n, s in zip(t.shape[:3], t.stride()[:3]))


def _strides(t: torch.Tensor):
    """(b, l, h) strides in elements; a dim of size 1 gets its contiguous
    stride, since a view may give it any."""
    _, L, h, d = t.shape
    return [s if n != 1 else c for n, s, c in
            zip(t.shape[:3], t.stride()[:3], (L * h * d, h * d, d))]


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool) -> torch.Tensor:
    """K3 on a CUDA tensor, the plain version on a CPU tensor; anything the
    routed kernel does not take raises before any launch is counted."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention wants q, k, v of one (B, L, H, D) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    if not supports(q.shape):
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} is outside "
                         "supports() (L a multiple of 256 and >= 512, D a "
                         "multiple of 8, L * D <= 2**20)")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention wants the head dim contiguous "
                         "(stride 1) in q, k and v")
    b, L, h, d = q.shape
    if b > 65535 or h > 65535:
        raise ValueError(f"flash_attention: batch {b} or heads {h} over the "
                         "grid's 65535")
    if _route(q.dtype, d) == "tc":
        if not all(_tma_ready(t) for t in (q, k, v)):
            raise ValueError("flash_attention's tensor-core route (bf16, D <= "
                             "128) reads q, k, v by TMA: it wants 16-byte-"
                             "aligned base addresses and (b, l, h) strides "
                             "that are multiples of 16 bytes")
        kernel = FLASH_ATTENTION_TC
    else:
        kernel = FLASH_ATTENTION
    out = torch.empty((b, L, h, d), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v) for s in _strides(t)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, L,
               h, d, *strides, _scale(d), int(causal),
               int(q.dtype == torch.bfloat16), stream)
    return out


def _flash_backward_plain(q, k, v, out, do, causal: bool):
    """``_flash_bwd_impl`` in plain torch: pass 1 the row log-sum-exp by an
    online max/sum over key blocks; pass 2 ``D_i = rowsum(dO * O)`` and, per
    key block, the recomputed probabilities, dq accumulated and dk, dv of
    the block. Memory stays O(L * block), never O(L^2)."""
    b, L, h, d = q.shape
    block_k = BLOCK_K
    scale = _scale(d)
    qf = q.float() * scale
    kf, vf, dof = k.float(), v.float(), do.float()
    n_idx = torch.arange(L, device=q.device)

    def logits(k0):
        kblk = kf[:, k0:k0 + block_k]
        s = torch.einsum("blhd,bjhd->blhj", qf, kblk)
        if causal:
            k_idx = k0 + torch.arange(kblk.shape[1], device=q.device)
            mask = k_idx[None, None, None, :] > n_idx[None, :, None, None]
            s = torch.where(mask, torch.full_like(s, _NEG_INF), s)
        return s

    m = torch.full((b, L, h), _NEG_INF, device=q.device)
    s_sum = torch.zeros((b, L, h), device=q.device)
    for k0 in range(0, L, block_k):
        logit = logits(k0)
        m_new = torch.maximum(m, logit.amax(dim=-1))
        s_sum = s_sum * torch.exp(m - m_new) \
            + torch.exp(logit - m_new[..., None]).sum(dim=-1)
        m = m_new
    lse = m + torch.log(torch.clamp(s_sum, min=1e-30))

    d_row = (dof * out.float()).sum(dim=-1)                     # (b, L, h)
    dq = torch.zeros((b, L, h, d), device=q.device)
    dks, dvs = [], []
    for k0 in range(0, L, block_k):
        kblk, vblk = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
        p = torch.exp(logits(k0) - lse[..., None])              # (b,L,h,bk)
        dp = torch.einsum("blhd,bjhd->blhj", dof, vblk)
        ds = p * (dp - d_row[..., None])
        dq = dq + torch.einsum("blhj,bjhd->blhd", ds, kblk)
        dks.append(torch.einsum("blhj,blhd->bjhd", ds, qf))
        dvs.append(torch.einsum("blhj,blhd->bjhd", p, dof))
    dk, dv = torch.cat(dks, dim=1), torch.cat(dvs, dim=1)
    return ((dq * scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        out = _flash_forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = _flash_backward_plain(q, k, v, out, do, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """(B, L, H, D) fused attention, ``softmax(q k^T / sqrt(D)) v``.

    Differentiable: the backward recomputes attention blockwise
    (:func:`_flash_backward_plain`)."""
    return _FlashAttention.apply(q, k, v, causal)
