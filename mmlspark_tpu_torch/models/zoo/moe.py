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

``router="vmoe"`` gives V-MoE's rules instead (Riquelme et al. 2021,
arXiv:2106.05974, section 2 and appendix A), for ``vit.py::vmoe_b16``:

- the router is a D -> E Dense with no bias; in training its logits take
  noise of std ``noise_std / E``; the gates are the top K of the softmax
  of the (noisy) logits, not renormalised;
- the capacity is ``C = round(K * S * capacity_factor / E)``, the slots as
  above;
- the experts carry biases (``experts_up_bias`` (E, H),
  ``experts_down_bias`` (E, D)) and compute in ``dtype`` with fp32 sums;
  the output is in ``dtype``, as a dense ``MlpBlock``'s is;
- ``aux_loss`` is ``(L_imp + L_load) / 2``, each the squared coefficient
  of variation over experts: of the importance (the sum of each expert's
  softmax over the tokens), and of the load (the sum over tokens of
  ``1 - Phi((eta_K - logit_i) / sigma)``, the chance that expert i stays
  in the top K when its own noise is drawn again; eta_K the K-th largest
  noisy logit);
- tokens move by the index dispatch (``ops/moe.py``), with no (S, E, C)
  tensor; the GShard rules keep the one-hot route.

With ``noise_seed`` set, the block at depth ``layer`` draws its noise from
a ``torch.Generator`` on the input's device seeded with ``noise_seed *
65536 + layer``, the same draw at every training forward (comparisons
repeat it); without it the noise is drawn fresh, as published. An eval
forward adds none. Each index-routed forward adds its kept and dropped
(token, choice) pairs to a device counter (:meth:`MoeMlp.device_counters`)
that the trainer reads at its flush, and opens the hot spans
``moe:route``, ``moe:permute``, ``moe:experts`` and ``moe:unpermute``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mmlspark_tpu_torch.models.zoo import register_model, resolve_dtype
from mmlspark_tpu_torch.models.zoo.resnet import Dense
from mmlspark_tpu_torch.observability.spans import span
from mmlspark_tpu_torch.ops import moe as moe_ops
from mmlspark_tpu_torch.parallel import collectives
from mmlspark_tpu_torch.models.zoo.transformer import (
    DecoderBlock, TransformerLM, _lm_spec, gelu,
)


class MoeMlp(nn.Module):
    """x (B, L, D) -> (B, L, D) through ``num_experts`` routed FFNs.
    Parameters: ``router`` (Dense D -> E, fp32), ``experts_up`` (E, D, H)
    and ``experts_down`` (E, H, D), in the JAX package's layouts.

    With ``record_routing`` set, each forward keeps its gate indices, slot
    positions (S, K) int32 and capacity in ``routing`` (for checks).

    ``router`` is ``"gshard"`` (the JAX package's rules) or ``"vmoe"``
    (the module docstring's; then also ``experts_up_bias`` and
    ``experts_down_bias``, and no ``router.bias``), which routes by the
    index dispatch. ``noise_std``, ``noise_seed`` and ``layer`` set
    V-MoE's router noise."""

    def __init__(self, dim: int, num_experts: int = 8,
                 expert_hidden: Optional[int] = None, top_k: int = 2,
                 capacity_factor: float = 1.25, dtype=torch.bfloat16,
                 router: str = "gshard",
                 noise_std: float = 0.0, noise_seed: Optional[int] = None,
                 layer: int = 0):
        super().__init__()
        hidden = expert_hidden or 4 * dim
        vmoe = router == "vmoe"
        if router not in ("gshard", "vmoe"):
            raise ValueError(f"unknown router rules {router!r}")
        if vmoe and noise_std <= 0:
            raise ValueError("V-MoE's load loss needs router noise: "
                             f"noise_std={noise_std}")
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor = capacity_factor
        self.dtype = resolve_dtype(dtype)
        self.rules = router
        self.noise_std, self.noise_seed, self.layer = noise_std, noise_seed, layer
        # init_state draws a V-MoE bank by each expert's fan-in (D, H),
        # the GShard one by flax's fan-in of the whole array (E * D, E * H)
        self.per_expert_fan_in = vmoe
        self.router = Dense(dim, num_experts, torch.float32, use_bias=not vmoe)
        self.experts_up = nn.Parameter(torch.empty(num_experts, dim, hidden))
        self.experts_down = nn.Parameter(torch.empty(num_experts, hidden, dim))
        if vmoe:
            self.experts_up_bias = nn.Parameter(torch.empty(num_experts, hidden))
            self.experts_down_bias = nn.Parameter(torch.empty(num_experts, dim))
        else:
            self.experts_up_bias = self.experts_down_bias = None
        # (kept, dropped) pairs since the trainer's last read; not state
        self.register_buffer("routed_pairs", torch.zeros(2, dtype=torch.int64),
                             persistent=False)
        self.aux_loss: Optional[torch.Tensor] = None
        self.record_routing = False
        self.routing: Optional[dict] = None
        self._layout = None      # the mesh layout once bound
        self._split = None       # the group the expert compute splits over
        self._noise_gen: Optional[torch.Generator] = None

    def device_counters(self) -> dict:
        """``{registry name: device scalar}`` of the pairs kept and dropped
        since the last read (the index dispatch counts them; none on the
        one-hot route); the trainer reads them in its flush's one sync and
        then zeroes them."""
        if self.rules != "vmoe":
            return {}
        return {"moe.routed": self.routed_pairs[0],
                "moe.dropped": self.routed_pairs[1]}

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
        if self.rules == "vmoe":
            return self._forward_index(x)
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

    # -- the index dispatch (V-MoE's route) -----------------------------
    def _noise(self, logits: torch.Tensor) -> torch.Tensor:
        """A unit normal draw of the logits' shape: seeded anew at each
        forward with ``noise_seed``, else from the global generator."""
        if self.noise_seed is None:
            return torch.randn(logits.shape, device=logits.device)
        gen = self._noise_gen
        if gen is None or gen.device != logits.device:
            gen = self._noise_gen = torch.Generator(device=logits.device)
        gen.manual_seed(int(self.noise_seed) * 65536 + self.layer)
        return torch.randn(logits.shape, generator=gen, device=logits.device)

    def _vmoe_gates(self, logits: torch.Tensor):
        """(gates (S, K), expert ids (S, K), aux loss) by V-MoE's rules."""
        E, K = self.num_experts, self.top_k
        sigma = self.noise_std / E
        noisy = logits
        if self.training:
            noisy = logits + sigma * self._noise(logits)
        probs = torch.softmax(noisy, dim=-1)
        gate_vals, gate_idx = torch.topk(probs, K, dim=-1)
        # the K-th largest noisy logit; 1 - Phi(z) = erfc(z / sqrt 2) / 2
        eta = noisy.gather(1, gate_idx[:, K - 1:])
        stay = 0.5 * torch.erfc((eta - logits) / (sigma * math.sqrt(2.0)))
        aux = 0.5 * (_cv_squared(probs.sum(dim=0))
                     + _cv_squared(stay.sum(dim=0)))
        return gate_vals, gate_idx, aux

    def _forward_index(self, x: torch.Tensor) -> torch.Tensor:
        if self._layout is not None and self._layout.grad_axes:
            raise NotImplementedError("the index dispatch routes on one "
                                      "device")
        B, L, D = x.shape
        E, K = self.num_experts, self.top_k
        S = B * L
        xf = x.reshape(S, D)
        with span("moe", "route", hot=True):
            logits = self.router(xf.float())
            gates, gate_idx, aux = self._vmoe_gates(logits)
            C = max(1, round(K * S * self.capacity_factor / E))
            plan = moe_ops.index_plan(gate_idx, E, C)
            kept = plan.kept.sum(dtype=torch.int64)
            self.routed_pairs.add_(torch.stack([kept, K * S - kept]))
        if self.record_routing:
            self.routing = {"gate_idx": gate_idx.to(torch.int32).detach(),
                            "position": plan.position.detach(),
                            "capacity": C}
        with span("moe", "permute", hot=True):
            xe = moe_ops.permute(xf, plan, E, self.dtype)
        with span("moe", "experts", hot=True):
            ye = moe_ops.experts(xe.view(E, C, D), self.experts_up,
                                 self.experts_up_bias, self.experts_down,
                                 self.experts_down_bias, self.dtype,
                                 self.dtype)
        with span("moe", "unpermute", hot=True):
            y = moe_ops.unpermute(ye.view(E * C, D), gates, plan, self.dtype)
        self.aux_loss = aux
        return y.reshape(B, L, D)


def _cv_squared(v: torch.Tensor) -> torch.Tensor:
    """The squared coefficient of variation of ``v`` (population std)."""
    return v.var(unbiased=False) / v.mean() ** 2


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
