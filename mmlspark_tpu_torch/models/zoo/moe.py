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
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mmlspark_tpu_torch.models.zoo import register_model, resolve_dtype
from mmlspark_tpu_torch.models.zoo.resnet import Dense
from mmlspark_tpu_torch.parallel import collectives
from mmlspark_tpu_torch.models.zoo.transformer import (
    DecoderBlock, TransformerLM, _lm_spec, gelu,
)


class MoeMlp(nn.Module):
    """x (B, L, D) -> (B, L, D) through ``num_experts`` routed FFNs.
    Parameters: ``router`` (Dense D -> E, fp32), ``experts_up`` (E, D, H)
    and ``experts_down`` (E, H, D), in the JAX package's layouts.

    With ``record_routing`` set, each forward keeps its gate indices, slot
    positions (S, K) int32 and capacity in ``routing`` (for checks)."""

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
        self.record_routing = False
        self.routing: Optional[dict] = None
        self._layout = None      # the mesh layout once bound
        self._split = None       # the group the expert compute splits over

    def bind_mesh(self, layout, shardings) -> dict:
        """Route over the global batch of the tokens split over the data
        (and sequence) ranks, and compute on the bank shards the rules
        give this rank: its experts (``expert``, dim 0) and, when the
        hidden dim is split over ``tensor``, its hidden columns and rows.
        Returns ``{leaf: axes kept}``; a bank's ``fsdp`` split is gathered
        for its use by the trainer."""
        self._layout = layout
        up, down = shardings.get("experts_up"), shardings.get("experts_down")
        axes = []
        if up is not None and up.spec[0] == "expert" == down.spec[0]:
            axes.append("expert")
        if up is not None and up.spec[2] == "tensor" == down.spec[1]:
            axes.append("tensor")
        self._split = layout.group(*axes) if axes else None
        kept = tuple(axes)
        return {"experts_up": kept, "experts_down": kept} if kept else {}

    # -- the global batch of a split one --------------------------------
    def _token_shards(self):
        """(batch blocks, sequence slices) the tokens are split into."""
        lay = self._layout
        nb = math.prod(lay.size(a) for a in lay.batch_axes)
        return nb, lay.size(lay.seq_axis) if lay.seq_axis else 1

    def _gather_tokens(self, t: torch.Tensor, B: int, L: int) -> torch.Tensor:
        """(B*L, K) of this rank's tokens -> (B_g*L_g, K) of the global
        batch, in its token order b*L_g + l."""
        lay = self._layout
        t = t.reshape(B, L, -1)
        if lay.seq_axis:
            t = collectives.all_gather(t, 1, lay.group(lay.seq_axis))
        t = collectives.all_gather(t, 0, lay.group(*lay.batch_axes))
        return t.reshape(-1, t.shape[-1])

    def _own_rows(self, t: torch.Tensor, B: int, L: int) -> torch.Tensor:
        """This rank's tokens' rows of a (B_g*L_g, K) global tensor."""
        lay = self._layout
        nb, ns = self._token_shards()
        block = 0
        for a in lay.batch_axes:
            block = block * lay.size(a) + lay.coord[a]
        piece = lay.coord[lay.seq_axis] if lay.seq_axis else 0
        t = t.reshape(B * nb, L * ns, -1)
        return t[block * B:(block + 1) * B,
                 piece * L:(piece + 1) * L].reshape(B * L, -1)

    def _positions(self, gate_idx: torch.Tensor, E: int):
        """Slot of each (token, choice) in its expert, counted in int32
        over (choice, token) order, and the first-choice one-hot."""
        S, K = gate_idx.shape
        onehot_i = F.one_hot(gate_idx.long(), E).to(torch.int32)  # (S, K, E)
        flat = onehot_i.transpose(0, 1).reshape(K * S, E)
        pos_flat = torch.cumsum(flat, dim=0, dtype=torch.int32) - flat
        position = (pos_flat.reshape(K, S, E).transpose(0, 1)
                    * onehot_i).sum(-1, dtype=torch.int32)        # (S, K)
        return position, onehot_i[:, 0, :]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, D = x.shape
        E, K = self.num_experts, self.top_k
        S = B * L
        lay = self._layout
        meshed = lay is not None and bool(lay.grad_axes)
        nb, ns = self._token_shards() if meshed else (1, 1)
        # the capacity and the slots are those of the GLOBAL batch, as
        # GSPMD computes them for the reference
        C = max(1, math.ceil(self.capacity_factor * S * nb * ns * K / E))
        xf = x.reshape(S, D)

        probs = torch.softmax(self.router(xf.float()), dim=-1)    # (S, E)
        gate_vals, gate_idx = torch.topk(probs, K, dim=-1)         # (S, K)
        gate_idx = gate_idx.to(torch.int32)
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(-1, keepdim=True), min=1e-9)

        if meshed:
            glob, first = self._positions(
                self._gather_tokens(gate_idx, B, L), E)
            position = self._own_rows(glob, B, L)
        else:
            position, first = self._positions(gate_idx, E)
        onehot_i = F.one_hot(gate_idx.long(), E).to(torch.int32)  # (S, K, E)
        keep = (position < C) & (onehot_i.sum(-1) > 0)
        if self.record_routing:
            self.routing = {"gate_idx": gate_idx.detach(),
                            "position": position.detach(), "capacity": C}

        # this rank's experts (all of them when the bank is not split)
        e_loc = self.experts_up.shape[0]
        e0 = lay.coord["expert"] * e_loc if e_loc < E else 0
        onehot = onehot_i[..., e0:e0 + e_loc].float()
        split = self._split
        gv = collectives.copy_to(gate_vals, split)
        # one_hot of a slot past C is all zeros, as jax.nn.one_hot gives it
        cap_onehot = (position[..., None] == torch.arange(
            C, device=x.device, dtype=torch.int32)).float()        # (S, K, C)
        dispatch = torch.einsum("ske,skc->sec",
                                onehot * keep[..., None], cap_onehot)
        combine = torch.einsum("ske,skc->sec",
                               onehot * (gv * keep)[..., None], cap_onehot)

        # jnp promotes a mixed einsum: the dtype-cast operands meet the fp32
        # input (and each other) in the wider dtype
        wide = torch.promote_types(self.dtype, xf.dtype)
        w_up = self.experts_up.to(self.dtype).to(wide)
        w_down = self.experts_down.to(self.dtype).to(wide)
        xe = torch.einsum("sec,sd->ecd", dispatch.to(self.dtype).to(wide),
                          collectives.copy_to(xf, split).to(wide))
        h = gelu(torch.einsum("ecd,edh->ech", xe, w_up))
        ye = torch.einsum("ech,ehd->ecd", h, w_down)
        y = torch.einsum("sec,ecd->sd", combine.to(self.dtype).to(wide), ye)
        # the other experts' (and hidden columns') partial outputs
        y = collectives.reduce_from(y, split)

        frac_routed = first.float().mean(dim=0)                    # 1st choice
        if meshed:
            # the global mean router probability; its all-reduce sums the
            # cotangent back over the ranks too, so the trainer's sum over
            # them divided by their count is the aux loss's gradient once
            group = lay.group(*lay.grad_axes)
            total = collectives.copy_to(
                collectives.reduce_from(probs.sum(dim=0), group), group)
            mean_prob = total / (S * nb * ns)
        else:
            mean_prob = probs.mean(dim=0)
        self.aux_loss = E * torch.sum(frac_routed * mean_prob)
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


def moe_aux_loss(source) -> torch.Tensor:
    """The sum of the load-balancing terms of a forward, fp32: of a module
    after its forward (each :class:`MoeMlp`'s ``aux_loss``), or of the
    ``"moe_aux"`` of ``forward_with_intermediates``' intermediates
    (already the sum over MoE blocks); zero when the model routes
    nothing, as the JAX package's sum over an empty ``losses`` collection
    is. The loss that weighs it stays the caller's (the JAX tests use
    ``ce + 0.01 * moe_aux_loss(state)``)."""
    if isinstance(source, nn.Module):
        aux = [m.aux_loss for m in source.modules()
               if isinstance(m, MoeMlp) and m.aux_loss is not None]
        if aux:
            return torch.stack(aux).sum().float()
        device = next((p.device for p in source.parameters()), None)
        return torch.zeros((), dtype=torch.float32, device=device)
    aux = source.get("moe_aux")
    if aux is not None:
        return aux.float()
    device = next((v.device for v in source.values()
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
