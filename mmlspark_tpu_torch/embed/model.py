"""DLRM-lite recommender: sparse embedding bags, dense towers and a dot
interaction, as one zoo architecture (``recommender_dlrm``).

The port of ``mmlspark_tpu/embed/model.py``, with the flax parameter names
(``bottom_fc{i}``, ``bottom_out``, ``<table>_embedding``, ``top_fc{i}``,
``head``), so ``models/convert.py::from_jax_params`` maps a flax DLRM's
tree onto it one to one (kernels transposed, tables as they are).

The wire format is ONE packed float32 row per example, ``[dense features
| slots ids per sparse feature ...]``: ids travel as float32 (exact up to
2^24) and are cast back to integers on the device; slot id 0 is the pad,
its weight 0.

The tables are named ``<feature>_embedding``, which lands them on the
``.*embedding$`` rule: on a mesh with a ``tensor`` axis they are split by
rows. Bound to such a mesh (``DistributedTrainer`` calls
:meth:`DLRM.bind_mesh`) with ``embed.fused_lookup`` on, the module keeps
its row shards, looks up through the fused all-to-all path and trains
them by the sparse scatter-add gradient (``embed/tables.py``), which is
already summed over the data ranks (``summed_grads``); otherwise the
trainer gathers each table for the reference gather.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmlspark_tpu_torch.embed.tables import (PAD_ID, bag_lookup_reference,
                                             make_bag_lookup)
from mmlspark_tpu_torch.models.zoo import register_model
from mmlspark_tpu_torch.models.zoo.resnet import Dense
from mmlspark_tpu_torch.utils import config as mmlconfig


class DLRM(nn.Module):
    """Two-tower DLRM-lite over packed rows (see the module docstring).
    ``tables`` is ``((name, rows), ...)`` in slot order."""

    def __init__(self, dense_dim: int, tables: Tuple[Tuple[str, int], ...],
                 embed_dim: int = 16, slots: int = 4,
                 bottom: Tuple[int, ...] = (32,),
                 top: Tuple[int, ...] = (32,), num_classes: int = 1,
                 lookup_fn: Optional[Callable] = None):
        super().__init__()
        self.dense_dim, self.embed_dim, self.slots = dense_dim, embed_dim, \
            slots
        self.tables = tuple((str(n), int(r)) for n, r in tables)
        self.bottom, self.top = tuple(bottom), tuple(top)
        self.lookup_fn = lookup_fn
        prev = dense_dim
        for i, width in enumerate(self.bottom):
            self.add_module(f"bottom_fc{i}", Dense(prev, width))
            prev = width
        self.bottom_out = Dense(prev, embed_dim)
        for name, rows in self.tables:
            self.register_parameter(f"{name}_embedding", nn.Parameter(
                torch.empty(rows, embed_dim)))
        f = 1 + len(self.tables)
        prev = embed_dim + f * (f - 1) // 2
        for i, width in enumerate(self.top):
            self.add_module(f"top_fc{i}", Dense(prev, width))
            prev = width
        self.head = Dense(prev, num_classes)
        self.summed_grads: Tuple[str, ...] = ()

    def bind_mesh(self, layout, shardings) -> dict:
        """On a mesh whose rules split the tables by rows over ``tensor``
        (and ``embed.fused_lookup`` on): look up through the fused path on
        the row shards, which the module keeps, with their gradients
        summed over the data ranks by the sparse path. Otherwise nothing
        is claimed and the tables are gathered for the reference gather."""
        names = [f"{n}_embedding" for n, _ in self.tables]
        fused = bool(mmlconfig.get("embed.fused_lookup")) and all(
            shardings[n].spec[:1] == ("tensor",) for n in names)
        self.summed_grads = tuple(names) if fused else ()
        if not fused:
            return {}
        self.lookup_fn = make_bag_lookup(layout.mesh)
        return {n: ("tensor",) for n in names}

    def forward_with_intermediates(self, x: torch.Tensor, layers=None):
        """``(logits, {"interaction": z, "head": logits})``."""
        x = x.float()
        h = x[:, :self.dense_dim]
        for i in range(len(self.bottom)):
            h = F.relu(getattr(self, f"bottom_fc{i}")(h))
        feats = [self.bottom_out(h)]
        lookup = self.lookup_fn or bag_lookup_reference
        off = self.dense_dim
        for name, _ in self.tables:
            ids = x[:, off:off + self.slots].long()
            off += self.slots
            weights = (ids != PAD_ID).float()
            feats.append(lookup(getattr(self, f"{name}_embedding"), ids,
                                weights))
        stack = torch.stack(feats, dim=1)                       # (B, F, D)
        # dot interaction: pairwise feature affinities, upper triangle
        dots = torch.einsum("bfd,bgd->bfg", stack, stack)
        # the upper triangle's indices made on the device (numpy's, the
        # same row-major order, would be a host copy a CUDA graph refuses)
        iu, ju = torch.triu_indices(stack.shape[1], stack.shape[1], 1,
                                    device=stack.device)
        z = torch.cat([feats[0], dots[:, iu, ju]], dim=1)
        out = z
        for i in range(len(self.top)):
            out = F.relu(getattr(self, f"top_fc{i}")(out))
        out = self.head(out)
        return out, {"interaction": z, "head": out}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_with_intermediates(x)[0]


def padded_rows(rows: int) -> int:
    # embed.row_multiple (default 8): the shard granule; any tensor axis
    # up to it divides every padded table evenly
    m = int(mmlconfig.get("embed.row_multiple"))
    return -(-int(rows) // m) * m


def pack_rows(dense: np.ndarray, sparse: Sequence[np.ndarray]) -> np.ndarray:
    """Host-side wire packing: float32 ``[dense | ids...]`` rows; each
    sparse block is (B, slots) integer ids (0 = pad)."""
    parts = [np.asarray(dense, np.float32)]
    parts += [np.asarray(ids, np.float32) for ids in sparse]
    return np.concatenate(parts, axis=1)


@register_model("recommender_dlrm")
def recommender_dlrm(dense_dim: int = 8,
                     tables: Any = (("user", 1024), ("item", 2048)),
                     embed_dim: int = 16, slots: int = 4,
                     bottom=(32,), top=(32,), num_classes: int = 1,
                     lookup_fn: Optional[Callable] = None):
    """Zoo constructor. ``tables`` is ``((name, rows), ...)``; rows round up
    to the shard multiple so any tensor axis up to it divides them.
    JSON-decoded specs arrive as lists, normalized here so saved stages
    rebuild the same module."""
    tabs = tuple((str(n), padded_rows(r)) for n, r in tables)
    width = dense_dim + len(tabs) * slots
    return dict(
        module=DLRM(dense_dim=dense_dim, tables=tabs, embed_dim=embed_dim,
                    slots=slots, bottom=tuple(bottom), top=tuple(top),
                    num_classes=num_classes, lookup_fn=lookup_fn),
        input_shape=(width,),
        feature_layer="interaction",
        feature_dim=None,
        layer_names=["interaction", "head"],
    )
