"""Single-device attention and the attention-function factory.

The port of ``mmlspark_tpu/parallel/sequence.py``'s single-device part:
:func:`full_attention` is the ``attention_fn`` every decoder block calls, on
(B, L, H, D). On a CUDA tensor whose shape :func:`ops.attention.supports`
admits, ``use_flash="auto"`` runs K3 (``ops/attention.py``); everything
else (CPU tensors, ragged lengths) takes the reference path, as the JAX
package does on its CPU backend.

Ring attention and Ulysses (context parallelism over a ``seq`` mesh axis)
are the multi-device layers of ROADMAP slice 6: :func:`make_attention_fn`
raises for them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from mmlspark_tpu_torch.ops import attention as _attention


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


def make_attention_fn(mesh: Optional[object] = None, impl: str = "auto",
                      seq_axis: str = "seq"):
    """``attention_fn`` factory for ``TransformerLM``: "full", or "auto"
    without a mesh, return :func:`full_attention`. "ring" and "ulysses"
    shard the sequence over a mesh axis and are not ported yet."""
    if impl == "auto" and mesh is None:
        impl = "full"
    if impl == "full":
        return full_attention
    if impl in ("ring", "ulysses", "auto"):
        raise NotImplementedError(
            f"{impl!r} attention shards the sequence over the {seq_axis!r} "
            "axis of a device mesh; meshes are ROADMAP slice 6 of the port "
            "(multi-device layers) and not ported yet")
    raise ValueError(f"unknown attention impl {impl!r}")
