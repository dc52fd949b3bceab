"""ResNets: CIFAR-style ResNet-20 and ResNet-50, as ``nn.Module``s.

The port of ``mmlspark_tpu/models/zoo/resnet.py``, holding the reference's
numerics and names so that :func:`mmlspark_tpu_torch.models.convert.
from_jax_params` maps a flax parameter tree onto these modules one to one:

- NHWC at the module's input (the reference's layout, so tests compare
  like with like); inside, NCHW-indexed tensors, which are channels-last in
  memory because the input is a permuted view of NHWC.
- flax ``padding="SAME"``: ``lo = total // 2`` and ``hi = total - lo``, so
  a stride-2 3x3 conv or max-pool on an even size pads (0, 1), not torch's
  symmetric (1, 1). Asymmetric pads go through ``F.pad``; the max-pool pads
  with ``-inf``.
- GroupNorm with ``min(32, features)`` groups and flax's eps 1e-6.
- ``dtype`` (bfloat16 by default, as in the reference's constructors): convs
  run in it, with their weights cast at the op; GroupNorm, the pooled
  features and the head run in float32; the residual is cast to the
  block's float32 output.
- the layer-name contract: ``pool`` (the pooled features) and ``head``
  (the logits), returned by ``forward_with_intermediates``
  (:class:`mmlspark_tpu_torch.models.zoo.PooledHead`); any other node is
  captured under the reference's name (``stage3_block2/out``) in NHWC
  (:func:`mmlspark_tpu_torch.models.zoo.node_forward`).
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from mmlspark_tpu_torch.models.zoo import (
    PooledHead, register_model, resolve_dtype,
)
from mmlspark_tpu_torch.models.zoo import (
    apply_with_intermediates as zoo_apply_with_intermediates,
)

Padding = Union[str, Tuple[Tuple[int, int], Tuple[int, int]]]


class ChannelsFirst:
    """A module computing on NCHW-indexed tensors: its captured output is
    moved to the reference's channels-last layout."""

    @staticmethod
    def to_reference_layout(args, y: torch.Tensor) -> torch.Tensor:
        return y.movedim(1, -1)


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """flax/XLA SAME padding (lo, hi) of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv(ChannelsFirst, nn.Module):
    """flax ``nn.Conv(use_bias=False)`` on NCHW-indexed tensors."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: Padding = "SAME", dtype=torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.k, self.stride, self.padding = k, stride, padding
        self.dtype = resolve_dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == "SAME":
            (t, b), (l, r) = (_same_pads(x.shape[2], self.k, self.stride),
                              _same_pads(x.shape[3], self.k, self.stride))
        else:
            (t, b), (l, r) = self.padding
        x = x.to(self.dtype)
        w = self.weight.to(self.dtype)
        if (t, l) == (b, r):
            return F.conv2d(x, w, stride=self.stride, padding=(t, l))
        return F.conv2d(F.pad(x, (l, r, t, b)), w, stride=self.stride)


class GroupNorm(ChannelsFirst, nn.Module):
    """flax ``nn.GroupNorm(num_groups=min(32, features), dtype=float32)``."""

    def __init__(self, features: int):
        super().__init__()
        self.groups = min(32, features)
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.groups, self.weight.float(),
                            self.bias.float(), eps=1e-6)


class Dense(nn.Module):
    """flax ``nn.Dense(dtype=...)``: weight (out, in), the input, weight
    and bias cast to ``dtype`` at the op (float32 by default); with
    ``use_bias=False`` (flax's ``use_bias``) there is no ``bias``."""

    split_heads = None   # the head count of a flax DenseGeneral (h, d) output

    def __init__(self, cin: int, cout: int, dtype=torch.float32,
                 use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout)) if use_bias else None
        self.dtype = resolve_dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)

    def to_reference_layout(self, args, y: torch.Tensor) -> torch.Tensor:
        if self.split_heads is None:
            return y
        return y.unflatten(-1, (self.split_heads, -1))


def _max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.max_pool(x, (3, 3), strides=(2, 2), padding="SAME")``."""
    t, b = _same_pads(x.shape[2], 3, 2)
    l, r = _same_pads(x.shape[3], 3, 2)
    return F.max_pool2d(F.pad(x, (l, r, t, b), value=float("-inf")), 3, 2)


class ResidualBlock(ChannelsFirst, nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1,
                 dtype=torch.bfloat16):
        super().__init__()
        self.conv1 = Conv(cin, features, 3, stride, dtype=dtype)
        self.norm1 = GroupNorm(features)
        self.conv2 = Conv(features, features, 3, dtype=dtype)
        self.norm2 = GroupNorm(features)
        if stride != 1 or cin != features:
            self.proj = Conv(cin, features, 1, stride, dtype=dtype)
            self.proj_norm = GroupNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        residual = x
        if hasattr(self, "proj"):
            residual = self.proj_norm(self.proj(x))
        return F.relu(y + residual.to(y.dtype))


class BottleneckBlock(ChannelsFirst, nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1,
                 dtype=torch.bfloat16):
        super().__init__()
        self.conv1 = Conv(cin, features, 1, dtype=dtype)
        self.norm1 = GroupNorm(features)
        self.conv2 = Conv(features, features, 3, stride, dtype=dtype)
        self.norm2 = GroupNorm(features)
        self.conv3 = Conv(features, features * 4, 1, dtype=dtype)
        self.norm3 = GroupNorm(features * 4)
        if stride != 1 or cin != features * 4:
            self.proj = Conv(cin, features * 4, 1, stride, dtype=dtype)
            self.proj_norm = GroupNorm(features * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = self.norm3(self.conv3(y))
        residual = x
        if hasattr(self, "proj"):
            residual = self.proj_norm(self.proj(x))
        return F.relu(y + residual.to(y.dtype))


class ResNet(PooledHead):
    """stage_sizes blocks per stage; CIFAR stem (3x3) or ImageNet stem
    (7x7/2 with explicit (3, 3) padding, then a SAME 3x3/2 max-pool).
    Submodule names are the flax module names (``stem_conv``,
    ``stage{i}_block{j}``, ``head``)."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 10,
                 width: int = 16, bottleneck: bool = False,
                 cifar_stem: bool = True, dtype=torch.bfloat16,
                 in_channels: int = 3):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        self.cifar_stem = cifar_stem
        if cifar_stem:
            self.stem_conv = Conv(in_channels, width, 3, dtype=dtype)
        else:
            self.stem_conv = Conv(in_channels, width, 7, 2,
                                  ((3, 3), (3, 3)), dtype=dtype)
            self.stem_norm = GroupNorm(width)
        block = BottleneckBlock if bottleneck else ResidualBlock
        self.block_names = []
        cin = width
        for i, n_blocks in enumerate(stage_sizes):
            features = width * (2 ** i)
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                name = f"stage{i}_block{j}"
                self.add_module(name, block(cin, features, stride, dtype))
                self.block_names.append(name)
                cin = features * (4 if bottleneck else 1)
        self.head = Dense(cin, num_classes)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) images -> (B, features) float32: the ``pool``
        layer."""
        x = self.stem_conv(x.permute(0, 3, 1, 2))
        if not self.cifar_stem:
            x = _max_pool_same(F.relu(self.stem_norm(x)))
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x.float().mean(dim=(2, 3))


@register_model("resnet20_cifar")
def resnet20_cifar(num_classes: int = 10, dtype=torch.bfloat16):
    return dict(
        module=ResNet(stage_sizes=[3, 3, 3], num_classes=num_classes,
                      width=16, bottleneck=False, cifar_stem=True, dtype=dtype),
        input_shape=(32, 32, 3),
        feature_layer="pool", feature_dim=64,
        layer_names=["pool", "head"],
    )


@register_model("resnet50")
def resnet50(num_classes: int = 1000, dtype=torch.bfloat16):
    return dict(
        module=ResNet(stage_sizes=[3, 4, 6, 3], num_classes=num_classes,
                      width=64, bottleneck=True, cifar_stem=False, dtype=dtype),
        input_shape=(224, 224, 3),
        feature_layer="pool", feature_dim=2048,
        layer_names=["pool", "head"],
    )


def apply_with_intermediates(module: ResNet, x: torch.Tensor,
                             capture_all: bool = False):
    """Forward returning ``(logits, {layer_name: activation})`` under the
    JAX package's names: ``pool`` and ``head``, and with ``capture_all``
    every submodule's output (``stage3_block2/out``,
    ``stage1_block0/conv2/out``, ...) in NHWC and the root's ``out``."""
    return zoo_apply_with_intermediates(module, x, capture_all=capture_all)
