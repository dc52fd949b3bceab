"""MLP for tabular frames: the deep learner's default architecture.

The port of ``mmlspark_tpu/models/zoo/mlp.py``, with the flax module
names, so :func:`mmlspark_tpu_torch.models.convert.from_jax_params` maps a
flax tree onto it one to one: hidden layers ``mlp_fc{i}`` (Dense in
``dtype``, bfloat16 by default, with float32 parameters cast at the op)
with ReLU, the features cast to float32 (the ``pool`` layer), and a
float32 ``head``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from mmlspark_tpu_torch.models.zoo import (
    PooledHead, register_model, resolve_dtype,
)
from mmlspark_tpu_torch.models.zoo.resnet import Dense


class MLP(PooledHead):
    def __init__(self, input_dim: int, hidden: Sequence[int],
                 num_classes: int, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        self.n_hidden = len(hidden)
        cin = int(input_dim)
        for i, h in enumerate(hidden):
            self.add_module(f"mlp_fc{i}", Dense(cin, int(h), self.dtype))
            cin = int(h)
        self.head = Dense(cin, num_classes)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, input_dim) -> (B, hidden[-1]) float32: the ``pool`` layer."""
        x = x.to(self.dtype)
        for i in range(self.n_hidden):
            x = F.relu(getattr(self, f"mlp_fc{i}")(x))
        return x.float()


@register_model("mlp_tabular")
def mlp_tabular(input_dim: int = 128, hidden=(512, 256), num_classes: int = 2,
                dtype=torch.bfloat16):
    return dict(
        module=MLP(input_dim, tuple(hidden), num_classes, dtype=dtype),
        input_shape=(input_dim,),
        feature_layer="pool", feature_dim=hidden[-1],
        layer_names=["pool", "head"],
    )
