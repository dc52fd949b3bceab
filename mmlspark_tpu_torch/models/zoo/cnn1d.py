"""1-D CNN text classifier (TextCNN), as an ``nn.Module``.

The port of ``mmlspark_tpu/models/zoo/cnn1d.py`` (BASELINE.json config 4,
TextFeaturizer + CNN on Amazon reviews), with the flax submodule names
(``embedding``, ``conv3``/``conv4``/``conv5``, ``head``), so
:func:`mmlspark_tpu_torch.models.convert.from_jax_params` maps a flax tree
onto it one to one. Numerics held to flax's:

- ``Embed(dtype)``: rows of the fp32 table cast to ``dtype`` (bf16 by
  default);
- per kernel width ``k`` a ``Conv(padding="SAME")`` in ``dtype``: flax
  convolves NWC, torch NCW, so the embedded ids are transposed; SAME pads
  ``(k - 1) // 2`` on the left and the rest on the right (1 and 2 at
  ``k = 4``); the conv runs without its bias, which is added after, in
  ``dtype``, as flax adds it;
- ReLU, then a max over the sequence (``amax``, whose gradient splits
  evenly between tied maxima as ``jnp.max``'s does);
- the pools concatenated and cast to fp32 (the ``pool`` layer), then an
  fp32 Dense ``head``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mmlspark_tpu_torch.models.zoo import (
    PooledHead, register_model, resolve_dtype,
)
from mmlspark_tpu_torch.models.zoo.resnet import Dense, _same_pads
from mmlspark_tpu_torch.models.zoo.transformer import Embed


class Conv1d(nn.Module):
    """flax ``nn.Conv(features, (k,), padding="SAME", dtype=dtype)`` on
    (B, C, L) tensors: weight (out, in, k), bias added after the conv in
    ``dtype``."""

    def __init__(self, cin: int, cout: int, k: int, dtype=torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k))
        self.bias = nn.Parameter(torch.empty(cout))
        self.k = k
        self.dtype = resolve_dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi = _same_pads(x.shape[-1], self.k, 1)
        y = F.conv1d(F.pad(x.to(self.dtype), (lo, hi)),
                     self.weight.to(self.dtype))
        return y + self.bias.to(self.dtype)[:, None]

    @staticmethod
    def to_reference_layout(args, y: torch.Tensor) -> torch.Tensor:
        return y.transpose(1, 2)      # flax's (B, L, C)


class TextCNN(PooledHead):
    """ids (B, L) int -> logits (B, num_classes) fp32; ``pool`` is the
    (B, filters * len(kernel_sizes)) fp32 concat of the max-pools."""

    def __init__(self, vocab_size: int, embed_dim: int = 128,
                 kernel_sizes: Sequence[int] = (3, 4, 5), filters: int = 128,
                 num_classes: int = 2, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        self.kernel_sizes = tuple(kernel_sizes)
        self.embedding = Embed(vocab_size, embed_dim, self.dtype)
        for k in self.kernel_sizes:
            self.add_module(f"conv{k}",
                            Conv1d(embed_dim, filters, k, self.dtype))
        self.head = Dense(filters * len(self.kernel_sizes), num_classes,
                          torch.float32)

    def forward_features(self, ids: torch.Tensor) -> torch.Tensor:
        x = self.embedding(ids.long()).transpose(1, 2)        # (B, E, L)
        pools = [torch.relu(getattr(self, f"conv{k}")(x)).amax(dim=-1)
                 for k in self.kernel_sizes]
        return torch.cat(pools, dim=-1).float()


@register_model("textcnn")
def textcnn(vocab_size: int = 1 << 15, embed_dim: int = 128,
            num_classes: int = 2, seq_len: int = 256, dtype=torch.bfloat16):
    m = TextCNN(vocab_size=vocab_size, embed_dim=embed_dim,
                num_classes=num_classes, dtype=dtype)
    return dict(
        module=m, input_shape=(seq_len,), input_dtype="int32",
        feature_layer="pool", feature_dim=128 * 3,
        layer_names=["pool", "head"],
    )
