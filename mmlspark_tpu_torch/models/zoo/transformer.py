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
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mmlspark_tpu_torch.models.zoo import register_model, resolve_dtype
from mmlspark_tpu_torch.models.zoo.resnet import Dense
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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

    def forward_hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, L) -> the final-normed fp32 activations (B, L, dim):
        the ``hidden`` layer."""
        L = tokens.shape[1]
        x = self.token_embedding(tokens)
        x = x + self.pos_embedding[:, :L].to(x.dtype)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        return self.final_norm(x)

    def head(self, hidden: torch.Tensor) -> torch.Tensor:
        """The tied head in fp32 (flax's ``Embed.attend`` would demote it)."""
        return torch.einsum("bld,vd->blv", hidden.float(),
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

