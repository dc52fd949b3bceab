"""Mixture-of-Experts: a top-k routed FFN, and the MoE LM.

The port of ``mmlspark_tpu/models/zoo/moe.py`` (GShard/Switch style), with
its semantics kept step for step:

- the router is an fp32 Dense on the fp32 input; softmax, top-k and the
  renormalised gates in fp32;
- each (token, choice) takes a slot of its expert by an int32 cumulative
  count in (choice, token) order: first every token's first choice, then
  the second choices;
- the capacity is ``C = ceil(capacity_factor * S * k / E)`` with S the
  tokens of the whole (padded) batch; a choice past C is dropped and the
  token keeps its residual;
- dispatch and combine are einsums against one-hot (S, E, C) tensors, cast
  to ``dtype`` as jnp casts them, then promoted with the fp32 input to
  fp32 as jnp promotes a mixed einsum; the MoE output is therefore fp32,
  and so is the residual stream after the first MoE block.

The load-balancing loss (E * sum over experts of the first-choice share
times the mean router probability) is computed on every forward and read
by :meth:`TransformerLM.forward_with_intermediates` as ``moe_aux`` (the
sum over MoE blocks), where the JAX package sows it under
``("losses", "moe_aux")``. :func:`moe_aux_loss` sums it for a training
loss, as the JAX package's ``moe_aux_loss`` sums the sown terms.

``transformer_lm_moe`` is ``TransformerLM`` with the dense MLP of every
odd block swapped for :class:`MoeMlp`; every block's attention is K3's.
"""
from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mmlspark_tpu_torch.models.zoo import register_model, resolve_dtype
from mmlspark_tpu_torch.models.zoo.resnet import Dense
from mmlspark_tpu_torch.models.zoo.transformer import (
    DecoderBlock, TransformerLM, _lm_spec, gelu,
)


class MoeMlp(nn.Module):
    """x (B, L, D) -> (B, L, D) through ``num_experts`` routed FFNs.
    Parameters: ``router`` (Dense D -> E, fp32), ``experts_up`` (E, D, H)
    and ``experts_down`` (E, H, D), in the JAX package's layouts."""

    def __init__(self, dim: int, num_experts: int = 8,
                 expert_hidden: Optional[int] = None, top_k: int = 2,
                 capacity_factor: float = 1.25, dtype=torch.bfloat16):
        super().__init__()
        hidden = expert_hidden or 4 * dim
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor = capacity_factor
        self.dtype = resolve_dtype(dtype)
        self.router = Dense(dim, num_experts, torch.float32)
        self.experts_up = nn.Parameter(torch.empty(num_experts, dim, hidden))
        self.experts_down = nn.Parameter(torch.empty(num_experts, hidden, dim))
        self.aux_loss: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, D = x.shape
        E, K = self.num_experts, self.top_k
        S = B * L
        C = max(1, math.ceil(self.capacity_factor * S * K / E))
        xf = x.reshape(S, D)

        probs = torch.softmax(self.router(xf.float()), dim=-1)    # (S, E)
        gate_vals, gate_idx = torch.topk(probs, K, dim=-1)         # (S, K)
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(-1, keepdim=True), min=1e-9)

        # slot of each (token, choice) in its expert, counted in int32 over
        # (choice, token) order
        onehot_i = F.one_hot(gate_idx, E).to(torch.int32)          # (S, K, E)
        flat = onehot_i.transpose(0, 1).reshape(K * S, E)
        pos_flat = torch.cumsum(flat, dim=0, dtype=torch.int32) - flat
        position = (pos_flat.reshape(K, S, E).transpose(0, 1)
                    * onehot_i).sum(-1, dtype=torch.int32)         # (S, K)
        keep = (position < C) & (onehot_i.sum(-1) > 0)
        onehot = onehot_i.float()

        # one_hot of a slot past C is all zeros, as jax.nn.one_hot gives it
        cap_onehot = (position[..., None] == torch.arange(
            C, device=x.device, dtype=torch.int32)).float()        # (S, K, C)
        dispatch = torch.einsum("ske,skc->sec",
                                onehot * keep[..., None], cap_onehot)
        combine = torch.einsum("ske,skc->sec",
                               onehot * (gate_vals * keep)[..., None],
                               cap_onehot)

        # jnp promotes a mixed einsum: the dtype-cast operands meet the fp32
        # input (and each other) in the wider dtype
        wide = torch.promote_types(self.dtype, xf.dtype)
        w_up = self.experts_up.to(self.dtype).to(wide)
        w_down = self.experts_down.to(self.dtype).to(wide)
        xe = torch.einsum("sec,sd->ecd", dispatch.to(self.dtype).to(wide),
                          xf.to(wide))
        h = gelu(torch.einsum("ecd,edh->ech", xe, w_up))
        ye = torch.einsum("ech,ehd->ecd", h, w_down)
        y = torch.einsum("sec,ecd->sd", combine.to(self.dtype).to(wide), ye)

        frac_routed = onehot[:, 0, :].mean(dim=0)                  # 1st choice
        self.aux_loss = E * torch.sum(frac_routed * probs.mean(dim=0))
        return y.reshape(B, L, D)


def _moe_lm(vocab, dim, depth, heads, max_len, num_experts, top_k,
            capacity_factor, dtype, attention_fn):
    """TransformerLM whose odd blocks route their FFN through MoeMlp."""

    def block_factory(i, name):
        ffn = None
        if i % 2 == 1:
            def ffn(fname):
                return MoeMlp(dim, num_experts=num_experts, top_k=top_k,
                              capacity_factor=capacity_factor, dtype=dtype)
        return DecoderBlock(dim, heads, dtype=dtype,
                            attention_fn=attention_fn, ffn_factory=ffn)

    return TransformerLM(vocab=vocab, dim=dim, depth=depth, heads=heads,
                         max_len=max_len, dtype=dtype,
                         attention_fn=attention_fn,
                         block_factory=block_factory)


def moe_aux_loss(inters: Mapping) -> torch.Tensor:
    """The sum of the load-balancing terms of a forward, fp32: the
    ``"moe_aux"`` of ``forward_with_intermediates``' intermediates (already
    the sum over MoE blocks), or zero when the model routes nothing, as the
    JAX package's sum over an empty ``losses`` collection is. The loss
    that weighs it stays the caller's (the JAX tests use ``ce + 0.01 *
    moe_aux_loss(state)``)."""
    aux = inters.get("moe_aux")
    if aux is not None:
        return aux.float()
    device = next((v.device for v in inters.values()
                   if isinstance(v, torch.Tensor)), None)
    return torch.zeros((), dtype=torch.float32, device=device)


@register_model("transformer_lm_moe")
def transformer_lm_moe(vocab: int = 32000, dim: int = 512, depth: int = 6,
                       heads: int = 8, max_len: int = 2048,
                       num_experts: int = 8, top_k: int = 2,
                       capacity_factor: float = 1.25,
                       dtype=torch.bfloat16, attention_fn=None):
    return _lm_spec(_moe_lm(vocab, dim, depth, heads, max_len, num_experts,
                            top_k, capacity_factor, dtype, attention_fn),
                    dim, max_len)


@register_model("transformer_lm_moe_tiny")
def transformer_lm_moe_tiny(vocab: int = 256, dim: int = 64, depth: int = 2,
                            heads: int = 4, max_len: int = 128,
                            num_experts: int = 4, top_k: int = 2,
                            capacity_factor: float = 2.0,
                            dtype=torch.float32, attention_fn=None):
    """Test-scale MoE LM (fp32; generous capacity so tiny batches route)."""
    return _lm_spec(_moe_lm(vocab, dim, depth, heads, max_len, num_experts,
                            top_k, capacity_factor, dtype, attention_fn),
                    dim, max_len)
