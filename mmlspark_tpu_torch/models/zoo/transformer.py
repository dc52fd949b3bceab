"""Decoder-only transformer LM, as ``nn.Module``s.

The port of ``mmlspark_tpu/models/zoo/transformer.py``, with the flax
submodule names (``token_embedding``, ``pos_embedding``, ``block{i}`` with
``norm1``, ``attn_query``/``attn_key``/``attn_value``/``attn_out``,
``norm2``, ``mlp_up``/``mlp_down``, ``final_norm``), so
:func:`mmlspark_tpu_torch.models.convert.from_jax_params` maps a flax tree
onto it one to one. Every block calls a pluggable
``attention_fn(q, k, v, causal=True)`` on (B, L, H, D), by default
:func:`mmlspark_tpu_torch.parallel.sequence.full_attention`, which runs K3
on the card.

Numerics held to flax's:

- ``LayerNorm(dtype=float32)``: statistics in fp32 as E[x^2] - E[x]^2
  clamped at 0, eps 1e-6, output fp32 whatever the input dtype;
- ``Dense(dtype=bf16)`` casts the input, the kernel and the bias to bf16
  and returns bf16 (:class:`~mmlspark_tpu_torch.models.zoo.resnet.Dense`);
  the residual stream stays in the dtype the sums give (bf16 + fp32 is
  fp32, as jnp promotes);
- ``gelu`` is the tanh approximation;
- ``Embed(dtype=bf16)`` returns bf16 rows of the fp32 table, and the
  position table is cast to the activations' dtype;
- the tied head is an fp32 product against the fp32 table, and ``hidden``
  is the final-normed fp32 activation.

On a mesh (``parallel/trainer.py`` calls each module's ``bind_mesh``),
what GSPMD did for the reference from the sharding rules is written out:

- **tensor**: a block whose q/k/v and ``mlp_up`` weights are split by
  output features and ``attn_out`` / ``mlp_down`` by input features over
  ``tensor`` computes on its shards (Megatron's column and row split):
  the attention function sees only the rank's heads, and the row split's
  partial outputs are summed over ``tensor`` (:func:`collectives
  .reduce_from`) before the replicated bias. A vocabulary split over
  ``tensor`` looks up its rows and sums, and the tied head returns the
  rank's slice of the logits, never the whole (B, L, vocab) tensor:
  :func:`next_token_loss` takes the cross entropy over the slices;
- **seq**: each rank holds a slice of the sequence, adds the positions of
  its slice, and its blocks must attend through a sequence-parallel
  ``attention_fn`` (``make_attention_fn(mesh, "ring" | "ulysses")``).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mmlspark_tpu_torch.models.zoo import register_model, resolve_dtype
from mmlspark_tpu_torch.models.zoo.resnet import Dense
from mmlspark_tpu_torch.parallel import collectives
from mmlspark_tpu_torch.parallel.sequence import full_attention


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)`` over the last axis."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        mean2 = (x * x).mean(dim=-1, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return (x - mean) * mul + self.bias.float()


class Embed(nn.Module):
    """flax ``nn.Embed(dtype=...)``: rows of the fp32 table in ``dtype``."""

    def __init__(self, num: int, features: int, dtype=torch.bfloat16):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num, features))
        self.dtype = resolve_dtype(dtype)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embedding.to(self.dtype))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class DecoderBlock(nn.Module):
    """Pre-norm decoder block with pluggable attention and FFN.

    ``ffn_factory(name) -> nn.Module`` swaps the dense MLP for a routed one
    (``zoo/moe.MoeMlp``), registered under ``name`` ("ffn")."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4,
                 dtype=torch.bfloat16,
                 attention_fn: Optional[Callable] = None,
                 ffn_factory: Optional[Callable[[str], nn.Module]] = None):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.dtype = resolve_dtype(dtype)
        self.attention_fn = attention_fn
        self.norm1 = LayerNorm(dim)
        self.attn_query = Dense(dim, dim, self.dtype)
        self.attn_key = Dense(dim, dim, self.dtype)
        self.attn_value = Dense(dim, dim, self.dtype)
        self.attn_out = Dense(dim, dim, self.dtype)
        self.norm2 = LayerNorm(dim)
        self.has_ffn = ffn_factory is not None
        if self.has_ffn:
            self.add_module("ffn", ffn_factory("ffn"))
        else:
            self.mlp_up = Dense(dim, dim * mlp_ratio, self.dtype)
            self.mlp_down = Dense(dim * mlp_ratio, dim, self.dtype)
        self._tp = None          # the tensor group once bound to a mesh

    # weights a tensor-split block computes on, and the dim split over
    # `tensor`: columns (output features, 0) or rows (input features, 1)
    _COLUMNS = ("attn_query", "attn_key", "attn_value", "mlp_up")
    _ROWS = ("attn_out", "mlp_down")

    def bind_mesh(self, layout, shardings) -> set:
        """Compute on the rank's shards when the rules split this block
        Megatron's way over ``tensor`` (``shardings``: this block's
        leaves by name); returns the weights it so consumes whole-shard.
        Otherwise it stays unbound and its split weights are gathered."""
        self._tp = None
        for name in self._COLUMNS:
            if hasattr(self, name):
                getattr(self, name).split_columns = None
        t = layout.size("tensor")
        if t == 1 or self.heads % t:
            return set()
        want = {f"{n}.weight": 0 for n in self._COLUMNS}
        want.update({f"{n}.weight": 1 for n in self._ROWS})
        want = {k: d for k, d in want.items() if k in shardings}
        if len(want) != (4 if self.has_ffn else 6) or any(
                shardings[k].spec[d] != "tensor" for k, d in want.items()):
            return set()
        if any(shardings[n.replace(".weight", ".bias")].sharded
               for n, d in want.items() if d == 0):
            return set()
        self._tp = layout.group("tensor")
        for name in self._COLUMNS:
            if hasattr(self, name):
                # a hook on a column-split Dense sees the rank's features
                getattr(self, name).split_columns = self._tp
        return set(want)

    def _columns(self, dense: Dense, y: torch.Tensor) -> torch.Tensor:
        """A column-split Dense: the rank's output features (the bias,
        replicated, sliced to them). The Dense's forward hooks still see
        its output (the generate lane taps the K/V projections)."""
        bias = collectives.slice_of(dense.bias, 0, self._tp)
        out = F.linear(y.to(dense.dtype), dense.weight.to(dense.dtype),
                       bias.to(dense.dtype))
        for hook in dense._forward_hooks.values():
            got = hook(dense, (y,), out)
            out = out if got is None else got
        return out

    def _rows(self, dense: Dense, h: torch.Tensor) -> torch.Tensor:
        """A row-split Dense: partial products summed over ``tensor``,
        then the bias. The Dense's forward hooks see the summed output."""
        part = F.linear(h.to(dense.dtype), dense.weight.to(dense.dtype))
        out = collectives.reduce_from(part, self._tp) \
            + dense.bias.to(dense.dtype)
        for hook in dense._forward_hooks.values():
            got = hook(dense, (h,), out)
            out = out if got is None else got
        return out

    def _forward_split(self, x: torch.Tensor) -> torch.Tensor:
        B, L, _ = x.shape
        heads = self.heads // collectives.size(self._tp)
        attn_fn = self.attention_fn or full_attention
        y = collectives.copy_to(self.norm1(x), self._tp)
        shape = (B, L, heads, self.dim // self.heads)
        o = attn_fn(self._columns(self.attn_query, y).reshape(shape),
                    self._columns(self.attn_key, y).reshape(shape),
                    self._columns(self.attn_value, y).reshape(shape),
                    causal=True)
        x = x + self._rows(self.attn_out, o.reshape(B, L, -1))
        if self.has_ffn:
            return x + self.ffn(self.norm2(x))
        y = collectives.copy_to(self.norm2(x), self._tp)
        return x + self._rows(self.mlp_down,
                              gelu(self._columns(self.mlp_up, y)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._tp is not None:
            return self._forward_split(x)
        B, L, _ = x.shape
        attn_fn = self.attention_fn or full_attention
        y = self.norm1(x)
        shape = (B, L, self.heads, self.dim // self.heads)
        o = attn_fn(self.attn_query(y).reshape(shape),
                    self.attn_key(y).reshape(shape),
                    self.attn_value(y).reshape(shape), causal=True)
        # bf16 + fp32 is fp32 in torch as in jnp
        x = x + self.attn_out(o.reshape(B, L, self.dim))
        y = self.norm2(x)
        if self.has_ffn:
            return x + self.ffn(y)
        return x + self.mlp_down(gelu(self.mlp_up(y)))


class TransformerLM(nn.Module):
    """Decoder LM trunk: tokens (B, L) int -> logits (B, L, vocab) fp32.

    ``block_factory(layer_idx, name) -> nn.Module`` customizes single
    layers (the MoE LM's routed FFNs) while the embedding, positions and
    tied head stay here."""

    # the JAX package's sown names -> this module's intermediates keys
    SOWN = {"hidden": "hidden", "head": "logits"}

    def __init__(self, vocab: int = 32000, dim: int = 512, depth: int = 6,
                 heads: int = 8, max_len: int = 2048, dtype=torch.bfloat16,
                 attention_fn: Optional[Callable] = None,
                 block_factory: Optional[Callable[[int, str],
                                                  nn.Module]] = None):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        self.vocab, self.dim, self.depth = vocab, dim, depth
        self.heads, self.max_len = heads, max_len
        self.token_embedding = Embed(vocab, dim, self.dtype)
        self.pos_embedding = nn.Parameter(torch.empty(1, max_len, dim))
        for i in range(depth):
            name = f"block{i}"
            block = (block_factory(i, name) if block_factory is not None
                     else DecoderBlock(dim, heads, dtype=self.dtype,
                                       attention_fn=attention_fn))
            self.add_module(name, block)
        self.final_norm = LayerNorm(dim)
        self._vocab = None       # the tensor group of a split vocabulary
        self._seq = None         # the seq group of a split sequence

    def bind_mesh(self, layout, shardings) -> set:
        """Look up and score over a vocabulary split by rows over
        ``tensor``, and take a split sequence's positions; returns the
        leaves it consumes whole-shard. A split sequence needs every
        block to attend through a sequence-parallel ``attention_fn``."""
        self._vocab = self._seq = None
        claimed = set()
        emb = shardings.get("token_embedding.embedding")
        if emb is not None and emb.spec == ("tensor", None):
            self._vocab = layout.group("tensor")
            claimed.add("token_embedding.embedding")
        if layout.seq_axis:
            for i in range(self.depth):
                block = getattr(self, f"block{i}")
                fn = getattr(block, "attention_fn", None)
                if getattr(fn, "seq_parallel", None) != layout.seq_axis:
                    raise ValueError(
                        f"block{i} attends with {fn!r} but the sequence is "
                        f"split over {layout.seq_axis!r}: build the LM "
                        "with attention_fn=make_attention_fn(mesh, 'ring' "
                        "or 'ulysses')")
            self._seq = layout.group(layout.seq_axis)
        return claimed

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        if self._vocab is None:
            return self.token_embedding(tokens)
        # the rank's rows of the table; ids outside them look up zeros,
        # and the sum over `tensor` leaves each id its one row
        table = self.token_embedding.embedding
        n = table.shape[0]
        local = tokens - collectives.rank(self._vocab) * n
        inside = (local >= 0) & (local < n)
        rows = F.embedding(torch.where(inside, local, 0),
                           table.to(self.token_embedding.dtype))
        rows = rows.masked_fill(~inside[..., None], 0)
        out = collectives.reduce_from(rows, self._vocab)
        # the Embed's forward hooks see the summed (whole) rows
        for hook in self.token_embedding._forward_hooks.values():
            got = hook(self.token_embedding, (tokens,), out)
            out = out if got is None else got
        return out

    def forward_hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, L) -> the final-normed fp32 activations (B, L, dim):
        the ``hidden`` layer (on a split sequence, this rank's slice)."""
        L = tokens.shape[1]
        start = collectives.rank(self._seq) * L
        x = self._embed(tokens)
        x = x + self.pos_embedding[:, start:start + L].to(x.dtype)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        return self.final_norm(x)

    def head(self, hidden: torch.Tensor) -> torch.Tensor:
        """The tied head in fp32 (flax's ``Embed.attend`` would demote it);
        over a split vocabulary, this rank's slice of the logits."""
        return torch.einsum("bld,vd->blv",
                            collectives.copy_to(hidden.float(), self._vocab),
                            self.token_embedding.embedding.float())

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.head(self.forward_hidden(tokens))

    def forward_with_intermediates(self, tokens: torch.Tensor,
                                   layers: Optional[Sequence[str]] = None):
        """``(logits, {"hidden": ..., "logits": ...})``; with ``layers``
        naming only ``hidden`` the head is skipped (its output would be
        dead code, as XLA drops it under jit) and ``logits`` is None."""
        hidden = self.forward_hidden(tokens)
        inters = {"hidden": hidden}
        logits = None
        if layers is None or "logits" in layers:
            logits = self.head(hidden)
            inters["logits"] = logits
        aux = [m.aux_loss for m in self.modules()
               if getattr(m, "aux_loss", None) is not None]
        if aux:
            inters["moe_aux"] = torch.stack(aux).sum()
        return logits, inters


class _SplitVocabCrossEntropy(torch.autograd.Function):
    """Cross entropy of logits whose vocabulary is split over a group:
    (N, V/t) fp32 slices and (N,) labels -> (N,) losses, the max, the
    label's logit and the exp-sum each summed (or maxed) over the group,
    so no rank ever holds the (N, V) logits."""

    @staticmethod
    def forward(ctx, logits, labels, group):
        n = logits.shape[-1]
        local = labels - collectives.rank(group) * n
        inside = (local >= 0) & (local < n)
        idx = torch.where(inside, local, 0)
        top = collectives.all_reduce(logits.amax(dim=-1), group, "max")
        shifted = logits - top[:, None]
        picked = shifted.gather(1, idx[:, None]).squeeze(1)
        picked = collectives.all_reduce(picked.masked_fill(~inside, 0),
                                        group)
        e = torch.exp(shifted)
        total = collectives.all_reduce(e.sum(dim=-1), group)
        ctx.save_for_backward(e, total, idx, inside)
        return torch.log(total) - picked

    @staticmethod
    def backward(ctx, g):
        e, total, idx, inside = ctx.saved_tensors
        grad = e / total[:, None]
        grad.scatter_add_(1, idx[:, None], -inside.to(grad.dtype)[:, None])  # lint: allow-embed (softmax grad)
        return grad * g[:, None], None, None


def next_token_loss(module: "TransformerLM",
                    tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy of ``module`` on ``tokens`` (B, L):
    position i predicts token i + 1, the last position predicts nothing.

    Alone it is ``F.cross_entropy(logits[:, :-1], tokens[:, 1:])``. Inside
    a meshed step (``parallel.sharding.current()``) ``tokens`` is this
    rank's block: on a split sequence the label of the slice's last
    position is the first token of the next rank's slice (one ring step),
    over a split vocabulary the cross entropy runs on the logits' slices,
    and the result is this rank's share, scaled so that the trainer's
    mean over the data and sequence ranks is the global mean."""
    from mmlspark_tpu_torch.parallel import sharding
    layout = sharding.current()
    logits = module(tokens)
    if layout is None or (module._seq is None and module._vocab is None):
        v = logits.shape[-1]
        return F.cross_entropy(logits[:, :-1].reshape(-1, v).float(),
                               tokens[:, 1:].reshape(-1).long())
    B, L = tokens.shape
    seq = module._seq
    s, last = collectives.size(seq), collectives.rank(seq) == \
        collectives.size(seq) - 1
    following = collectives.ring_shift(tokens[:, :1].contiguous(), seq, -1)
    labels = torch.cat([tokens[:, 1:], following], dim=1).reshape(-1).long()
    flat = logits.reshape(B * L, -1).float()
    if module._vocab is not None:
        ce = _SplitVocabCrossEntropy.apply(flat, labels, module._vocab)
    else:
        ce = F.cross_entropy(flat, labels, reduction="none")
    ce = ce.reshape(B, L)
    if last:
        ce = ce[:, :-1]
    rows = B * math.prod(layout.size(a) for a in layout.batch_axes)
    return ce.sum() * (layout.n_grad / (rows * (L * s - 1)))


def _lm_spec(module: nn.Module, dim: int, max_len: int) -> dict:
    return dict(
        module=module,
        input_shape=(max_len,), input_dtype="int32",
        feature_layer="hidden", feature_dim=dim,
        layer_names=["hidden", "logits"],
        # decoder blocks use the (q, k, v, causal) attention contract
        seq_attention=True,
    )


@register_model("transformer_lm")
def transformer_lm(vocab: int = 32000, dim: int = 512, depth: int = 6,
                   heads: int = 8, max_len: int = 2048,
                   dtype=torch.bfloat16, attention_fn=None):
    return _lm_spec(TransformerLM(vocab=vocab, dim=dim, depth=depth,
                                  heads=heads, max_len=max_len, dtype=dtype,
                                  attention_fn=attention_fn), dim, max_len)


@register_model("transformer_lm_tiny")
def transformer_lm_tiny(vocab: int = 256, dim: int = 64, depth: int = 2,
                        heads: int = 4, max_len: int = 128,
                        dtype=torch.float32, attention_fn=None):
    """Test-scale LM (fp32, as the JAX package's)."""
    return _lm_spec(TransformerLM(vocab=vocab, dim=dim, depth=depth,
                                  heads=heads, max_len=max_len, dtype=dtype,
                                  attention_fn=attention_fn), dim, max_len)

