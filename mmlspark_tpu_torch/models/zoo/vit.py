"""ViT-B/16 and the small ViT, as ``nn.Module``s.

The port of ``mmlspark_tpu/models/zoo/vit.py``: patchify conv -> [CLS] ->
pre-norm encoder blocks (multi-head attention + MLP, tanh GELU) -> final
norm -> the CLS row (the ``pool`` layer) -> an fp32 ``head``. The flax
submodule names are kept (``patch_embedding``, ``cls``, ``pos_embedding``,
``block{i}`` with ``norm1``, ``attn`` (``query``/``key``/``value``/``out``),
``norm2``, ``mlp`` (``mlp_up``/``mlp_down``), ``final_norm``, ``head``);
:func:`~mmlspark_tpu_torch.models.convert.from_jax_params` flattens the
attention's rank-3 ``DenseGeneral`` kernels into (out, in) weights.

The attention is the twin of flax's ``MultiHeadDotProductAttention`` with
``nn.dot_product_attention`` in plain torch ops, not K3 (197 tokens is not
a multiple of K3's blocks), and in flax's dtypes: q divided by
``sqrt(head_dim)`` cast to ``dtype``, the scores, the softmax and the
weighted sum all in ``dtype`` (bf16 by default), as flax computes them
when ``force_fp32_for_softmax`` is off.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mmlspark_tpu_torch.models.zoo import (
    PooledHead, register_model, resolve_dtype,
)
from mmlspark_tpu_torch.models.zoo.resnet import Dense
from mmlspark_tpu_torch.models.zoo.transformer import LayerNorm, gelu


class MlpBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype=torch.bfloat16):
        super().__init__()
        self.mlp_up = Dense(dim, hidden, dtype)
        self.mlp_down = Dense(hidden, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp_down(gelu(self.mlp_up(x)))


def dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """flax ``nn.dot_product_attention`` on (B, N, H, D), no mask, no
    dropout: every step in the inputs' dtype."""
    depth = torch.sqrt(torch.tensor(float(q.shape[-1]))).to(q.dtype)
    w = torch.einsum("bqhd,bkhd->bhqk", q / depth, k)
    w = torch.softmax(w, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention(num_heads, dtype)`` on one input
    (self-attention); the projections are Dense layers in ``dtype``."""

    def __init__(self, dim: int, heads: int, dtype=torch.bfloat16,
                 attention_fn: Optional[Callable] = None):
        super().__init__()
        self.heads = heads
        self.dtype = resolve_dtype(dtype)
        self.attention_fn = attention_fn or dot_product_attention
        self.query = Dense(dim, dim, self.dtype)
        self.key = Dense(dim, dim, self.dtype)
        self.value = Dense(dim, dim, self.dtype)
        self.out = Dense(dim, dim, self.dtype)
        for proj in (self.query, self.key, self.value):
            proj.split_heads = heads   # flax's (h, d) DenseGeneral output

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, dim = x.shape
        shape = (B, N, self.heads, dim // self.heads)
        o = self.attention_fn(self.query(x).reshape(shape),
                              self.key(x).reshape(shape),
                              self.value(x).reshape(shape))
        return self.out(o.reshape(B, N, dim))


class EncoderBlock(nn.Module):
    """Pre-norm block; ``mlp_factory() -> nn.Module`` swaps the dense MLP
    for another under the same name ``mlp`` (V-MoE's routed one)."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4,
                 dtype=torch.bfloat16,
                 attention_fn: Optional[Callable] = None,
                 mlp_factory: Optional[Callable[[], nn.Module]] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = MultiHeadAttention(dim, heads, dtype, attention_fn)
        self.norm2 = LayerNorm(dim)
        self.mlp = (mlp_factory() if mlp_factory is not None
                    else MlpBlock(dim, dim * mlp_ratio, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbedding(nn.Module):
    """flax ``nn.Conv(dim, (p, p), strides=(p, p), dtype)`` with its bias,
    on NHWC images whose sides are multiples of p (SAME padding is then
    zero): (B, H, W, C) -> (B, H/p * W/p, dim), row-major patches."""

    def __init__(self, cin: int, dim: int, patch: int, dtype=torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, cin, patch, patch))
        self.bias = nn.Parameter(torch.empty(dim))
        self.patch = patch
        self.dtype = resolve_dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        y = F.conv2d(x, self.weight.to(self.dtype), self.bias.to(self.dtype),
                     stride=self.patch)
        return y.flatten(2).transpose(1, 2)

    def to_reference_layout(self, args, y: torch.Tensor) -> torch.Tensor:
        """(B, N, dim) -> flax's (B, H/p, W/p, dim) patch grid."""
        _, h, w, _ = args[0].shape
        return y.unflatten(1, (h // self.patch, w // self.patch))


class ViT(PooledHead):
    """``moe_layers`` lists the blocks whose MLP ``moe_factory(i)`` builds
    (V-MoE); the others keep the dense one."""

    def __init__(self, patch: int = 16, dim: int = 768, depth: int = 12,
                 heads: int = 12, num_classes: int = 1000,
                 dtype=torch.bfloat16, image_size: int = 224,
                 attention_fn: Optional[Callable] = None,
                 moe_layers: Sequence[int] = (),
                 moe_factory: Optional[Callable[[int], nn.Module]] = None):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        self.depth = depth
        tokens = (image_size // patch) ** 2 + 1
        self.patch_embedding = PatchEmbedding(3, dim, patch, self.dtype)
        self.cls = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embedding = nn.Parameter(torch.empty(1, tokens, dim))
        for i in range(depth):
            routed = (lambda i=i: moe_factory(i)) if i in moe_layers else None
            self.add_module(f"block{i}", EncoderBlock(
                dim, heads, dtype=self.dtype, attention_fn=attention_fn,
                mlp_factory=routed))
        self.final_norm = LayerNorm(dim)
        self.head = Dense(dim, num_classes)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) images -> the final-normed fp32 CLS row: ``pool``."""
        x = self.patch_embedding(x)
        cls = self.cls.to(x.dtype).expand(x.shape[0], 1, x.shape[2])
        x = torch.cat([cls, x], dim=1)
        x = x + self.pos_embedding.to(x.dtype)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        return self.final_norm(x)[:, 0]


@register_model("vit_b16")
def vit_b16(num_classes: int = 1000, image_size: int = 224,
            dtype=torch.bfloat16, attention_fn=None):
    return dict(
        module=ViT(patch=16, dim=768, depth=12, heads=12,
                   num_classes=num_classes, dtype=dtype,
                   image_size=image_size, attention_fn=attention_fn),
        input_shape=(image_size, image_size, 3),
        feature_layer="pool", feature_dim=768,
        layer_names=["pool", "head"],
    )


@register_model("vit_tiny")
def vit_tiny(num_classes: int = 10, image_size: int = 32, patch: int = 4,
             dtype=torch.bfloat16, attention_fn=None):
    """Small ViT for tests and CIFAR-scale experiments."""
    return dict(
        module=ViT(patch=patch, dim=192, depth=4, heads=3,
                   num_classes=num_classes, dtype=dtype,
                   image_size=image_size, attention_fn=attention_fn),
        input_shape=(image_size, image_size, 3),
        feature_layer="pool", feature_dim=192,
        layer_names=["pool", "head"],
    )


def _vmoe(patch, dim, depth, heads, num_classes, image_size, dtype,
          num_experts, top_k, moe_layers, capacity_factor, noise_std,
          noise_seed, attention_fn):
    from mmlspark_tpu_torch.models.zoo.moe import MoeMlp

    def moe(i):
        return MoeMlp(dim, num_experts=num_experts, expert_hidden=4 * dim,
                      top_k=top_k, capacity_factor=capacity_factor,
                      dtype=dtype, router="vmoe", noise_std=noise_std,
                      noise_seed=noise_seed, layer=i)
    return dict(
        module=ViT(patch=patch, dim=dim, depth=depth, heads=heads,
                   num_classes=num_classes, dtype=dtype,
                   image_size=image_size, attention_fn=attention_fn,
                   moe_layers=tuple(moe_layers), moe_factory=moe),
        input_shape=(image_size, image_size, 3),
        feature_layer="pool", feature_dim=dim,
        layer_names=["pool", "head"],
    )


@register_model("vmoe_b16", port_only=True)
def vmoe_b16(num_classes: int = 1000, image_size: int = 224,
             dtype=torch.bfloat16, num_experts: int = 32, top_k: int = 2,
             moe_layers=(1, 3, 5, 7, 9, 11), capacity_factor: float = 1.05,
             noise_std: float = 1.0, noise_seed=None, attention_fn=None):
    """V-MoE-B/16 (Riquelme et al. 2021, arXiv:2106.05974): ViT-B/16 whose
    blocks ``moe_layers`` ("Every-2") route their MLP over ``num_experts``
    experts of 768 -> 3072 -> 768, ``top_k`` a token, by V-MoE's rules
    (``moe.py``)."""
    return _vmoe(16, 768, 12, 12, num_classes, image_size, dtype,
                 num_experts, top_k, moe_layers, capacity_factor, noise_std,
                 noise_seed, attention_fn)


@register_model("vmoe_tiny", port_only=True)
def vmoe_tiny(num_classes: int = 10, image_size: int = 32, patch: int = 8,
              dim: int = 64, depth: int = 4, heads: int = 4,
              num_experts: int = 8, top_k: int = 2, moe_layers=(1, 3),
              capacity_factor: float = 1.05, noise_std: float = 1.0,
              noise_seed=None, dtype=torch.float32, attention_fn=None):
    """Test-scale V-MoE (fp32 by default)."""
    return _vmoe(patch, dim, depth, heads, num_classes, image_size, dtype,
                 num_experts, top_k, moe_layers, capacity_factor, noise_std,
                 noise_seed, attention_fn)
