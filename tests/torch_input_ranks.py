"""Rank-side functions of the port's multi-process input tests.

``mmlspark_tpu_torch.testing.ranks.RankPool`` runs these in gloo rank
processes on the CPU, as ``fn(rank, world, *args)``. This module imports
torch, numpy and the port only (never JAX): the ranks must not load it.
Inputs and results are numpy arrays and plain Python values.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mmlspark_tpu_torch.parallel import mesh as meshlib
from mmlspark_tpu_torch.utils import config


def _mesh(axes: Dict[str, int]):
    return meshlib.make_mesh(meshlib.MeshSpec(**axes))


def _cpu():
    return torch.device("cpu")


class _Configured:
    """Config keys set for the length of a call, then restored."""

    def __init__(self, **keys):
        self.keys = {k.replace("__", "."): v for k, v in keys.items()}

    def __enter__(self):
        self.saved = {k: config._overrides.get(k) for k in self.keys}
        for k, v in self.keys.items():
            config.set(k, v)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                config.unset(k)
            else:
                config.set(k, v)
        return False


def deep_shard_fit(rank, world, axes, x, y, kwargs, block_rows, init):
    """DeepClassifier over ``meshSpec=axes`` on this rank's block-cyclic
    shard, started from ``init`` (a state dict); the fitted params, final
    loss, validation history and the scores of the whole frame."""
    from mmlspark_tpu_torch.core.frame import Frame
    from mmlspark_tpu_torch.train import deep as tdeep
    whole = Frame.from_dict({"features": x, "label": y})
    saved = tdeep._DeepEstimatorBase._init_params
    if init is not None:
        tdeep._DeepEstimatorBase._init_params = \
            lambda self, module, seed: {k: np.array(v)
                                        for k, v in init.items()}
    try:
        model = tdeep.DeepClassifier(
            featuresCol="features", labelCol="label", meshSpec=axes,
            **kwargs).fit(whole.process_shard(block_rows=block_rows))
    finally:
        tdeep._DeepEstimatorBase._init_params = saved
    scored = model.transform(whole)
    return {"params": model._state["params"],
            "final_loss": float(model._state["final_loss"]),
            "history": model.validation_history,
            "prediction": np.asarray(scored.column("prediction")),
            "probability": np.asarray(scored.column("probability"))}


def allreduce_moments(rank, world, axes, shards):
    """``_allreduce_moments`` of this rank's shard's streaming moments over
    the data ranks; a raised ValueError comes back as its message."""
    from mmlspark_tpu_torch.core.frame import Frame
    from mmlspark_tpu_torch.parallel import sharding
    from mmlspark_tpu_torch.train.deep import DeepClassifier
    mesh = _mesh(axes)
    x, y = shards[sharding.batch_block(mesh)]
    est = DeepClassifier(featuresCol="features", labelCol="label")
    moments = est._streaming_moments(
        Frame.from_dict({"features": x, "label": y}))
    try:
        out = est._allreduce_moments(
            moments, sharding.axis_group(mesh, ("data",)))
    except ValueError as e:
        return {"error": str(e)}
    return {"moments": out}


def local_epoch_cache(rank, world, axes, data, batch, shuffle, epochs):
    """A local-rows DeviceEpochCache over this rank's block-cyclic rows of
    the global epoch ``data``: its batches of ``epochs`` epochs."""
    from mmlspark_tpu_torch.parallel import sharding
    from mmlspark_tpu_torch.parallel.trainer import DeviceEpochCache
    mesh = _mesh(axes)
    local = sharding.local_batch_rows(mesh, batch)
    block = sharding.batch_block(mesh)
    blocks = batch // local
    n = next(iter(data.values())).shape[0]
    rows = np.concatenate([np.arange(i + block * local, i + (block + 1)
                                     * local) for i in range(0, n, batch)])
    mine = {k: np.asarray(v)[rows] for k, v in data.items()}
    assert len(rows) * blocks == n
    cache = DeviceEpochCache(mine, batch, mesh=mesh, shuffle=shuffle,
                             seed=7, device=config.resolve_device(),
                             local=True)
    return {"epochs": [[{k: v.cpu().numpy().copy() for k, v in b.items()}
                        for b in cache.batches(e)] for e in range(epochs)],
            "local_batch": cache.local_batch, "block": block}


def cache_verdict(rank, world, axes, x, y, budgets_mb):
    """The epoch cache's verdict on this rank's shard at this rank's
    ``runtime.device_cache_mb`` (``budgets_mb[rank]``): True when it
    cached."""
    from mmlspark_tpu_torch.core.frame import Frame
    from mmlspark_tpu_torch.parallel import sharding
    from mmlspark_tpu_torch.train.learners import _epoch_device_cache
    mesh = _mesh(axes)
    local = sharding.local_batch_rows(mesh, 16)
    frame = Frame.from_dict({"features": x, "label": y}).process_shard(
        block_rows=local)
    with _Configured(runtime__device_cache_mb=budgets_mb[rank]):
        cache = _epoch_device_cache(frame, "features", "label", 16,
                                    np.int64, device=_cpu(), mesh=mesh,
                                    local_batch=local,
                                    steps=-(-len(y) // 16))
    return cache is not None


def learner_fits(rank, world, data_by_rank, names):
    """The built-in learners fit on this rank's own frame inside the
    group: their scores of that frame."""
    from mmlspark_tpu_torch.core.frame import Frame
    from mmlspark_tpu_torch.train import learners as tl
    x, y = data_by_rank[rank]
    frame = Frame.from_dict({"features": x, "label": y})
    out = {}
    for name in names:
        learner = make_learner(tl, name)
        scored = learner.fit(frame).transform(frame)
        col = "prediction" if name == "LinearRegression" else "probability"
        out[name] = np.asarray(scored.column(col))
    return out


def make_learner(tl, name):
    learner = {"LogisticRegression": lambda: tl.LogisticRegression(
                   maxIter=3, batchSize=16),
               "NaiveBayes": lambda: tl.NaiveBayes(),
               "LinearRegression": lambda: tl.LinearRegression()}[name]()
    learner.set_params(featuresCol="features", labelCol="label")
    return learner


class _Killed(Exception):
    pass


# the card's lane: uint8 rows of 8 x 8 x 3 through K1, then a linear layer
CARD_SHAPE = (8, 8, 3)


def _stream_trainer(axes, init, card=False):
    """A linear classifier on the mesh over ``axes``, sgd with momentum,
    on the CPU, or with ``card`` on ``runtime.device`` with K1 turning
    each batch's uint8 rows into its fp32 input."""
    from mmlspark_tpu_torch.parallel import optim
    from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer
    pre = None
    if card:
        from mmlspark_tpu_torch.ops.preprocess import make_preprocess_fn
        pre = make_preprocess_fn(CARD_SHAPE, (120.0, 110.0, 100.0),
                                 (60.0, 61.0, 62.0), out_dtype=torch.float32)

    def init_fn():
        m = torch.nn.Linear(init["weight"].shape[1], init["weight"].shape[0])
        m.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in init.items()})
        return m

    def loss_fn(module, batch, gen):
        x = batch["x"] if pre is None else \
            pre(batch["x"]).reshape(batch["x"].shape[0], -1)
        return F.cross_entropy(module(x), batch["y"].long())
    trainer = DistributedTrainer(loss_fn, optim.sgd(0.1, momentum=0.9),
                                 mesh=_mesh(axes),
                                 device=config.resolve_device() if card
                                 else _cpu())
    return trainer, init_fn


def stream_dataset(corpus: str, local_batch: int, kill_after: Optional[int],
                   dtype=np.float32):
    """Each rank's own stream: its contiguous share of the corpus files
    (``FileSource(process_shard=True)``), decoded (rows of ``dtype``),
    batched, repeated. ``kill_after`` records raise, as a kill would stop
    the run."""
    from mmlspark_tpu_torch.data.pipeline import FileSource
    seen = [0]

    def decode(rec):
        seen[0] += 1
        if kill_after is not None and seen[0] > kill_after:
            raise _Killed()
        row = np.frombuffer(rec["bytes"], dtype)
        # files are named <index>_<label>_.bin
        label = int(os.path.basename(rec["path"]).split("_")[1])
        return {"x": row.copy(), "y": np.int64(label)}
    return (FileSource(corpus, process_shard=True).map(decode)
            .batch(local_batch).repeat())


def run_dataset(rank, world, axes, corpus, ckpt_dir, total, local_batch,
                init, kill_at=None, card=False):
    """``ResilientTrainLoop.run_dataset`` on this rank's stream, saving
    every 5 steps; killed (the run stopped by an exception) while drawing
    step ``kill_at`` when given. With ``card``, the uint8 lane with K1 on
    ``runtime.device``. The final params (None when killed), the
    data-state files written, the step the run resumed from and the
    kernels' launches in the run."""
    from mmlspark_tpu_torch import kernels
    from mmlspark_tpu_torch.parallel.checkpoint import TrainCheckpointer
    from mmlspark_tpu_torch.reliability.resilient import ResilientTrainLoop
    if card:
        kernels.build_all([kernels.FUSED_NORMALIZE])
    trainer, init_fn = _stream_trainer(axes, init, card)
    ckpt = TrainCheckpointer(ckpt_dir)
    resumed = ckpt.latest_step() or 0
    loop = ResilientTrainLoop(trainer, ckpt, init_fn, save_every=5)
    kill_after = None if kill_at is None else (kill_at - 1) * local_batch
    data = stream_dataset(corpus, local_batch, kill_after,
                          np.uint8 if card else np.float32)
    kernels.reset_launches()
    try:
        state = loop.run_dataset(data, total)
        params = {k: v.detach().cpu().numpy().copy()
                  for k, v in state["module"].state_dict().items()}
    except _Killed:
        params = None
    finally:
        ckpt.close()
    return {"params": params, "resumed": resumed,
            "launches": {k.name: k.launches for k in kernels.KERNELS},
            "data_states": sorted(n for n in os.listdir(ckpt_dir)
                                  if n.startswith("data_state-"))}


def late_lister(rank, world, axes, directory, init, total):
    """A meshed ``ResilientTrainLoop.run`` of ``total`` steps with no
    cadence saves, whose rank 1 lists the checkpoint directory 0.5 s late:
    every rank must still make the final save (its gathers and waits are
    collective) and close. The committed steps."""
    import time
    from mmlspark_tpu_torch.parallel.checkpoint import TrainCheckpointer
    from mmlspark_tpu_torch.reliability.resilient import ResilientTrainLoop
    trainer, init_fn = _stream_trainer(axes, init)
    ckpt = TrainCheckpointer(directory)
    if rank == 1:
        listing = ckpt.latest_step

        def late():
            time.sleep(0.5)
            return listing()
        ckpt.latest_step = late
    rng = np.random.default_rng(rank)
    batches = [{"x": rng.normal(size=(4, 4)).astype(np.float32),
                "y": rng.integers(0, 4, 4)} for _ in range(total)]
    loop = ResilientTrainLoop(trainer, ckpt, init_fn, save_every=0)
    try:
        loop.run(lambda step: batches[step - 1], total)
    finally:
        ckpt.close()
    return ckpt.all_steps()


def run_dataset_dry(rank, world, axes, corpus, ckpt_dir, total,
                    local_batch, init, files_by_rank):
    """A meshed run_dataset whose rank 1 runs out of batches first
    (``repeat`` off, a shorter shard): the error each rank raised."""
    from mmlspark_tpu_torch.data.pipeline import FileSource
    from mmlspark_tpu_torch.parallel.checkpoint import TrainCheckpointer
    from mmlspark_tpu_torch.reliability.resilient import ResilientTrainLoop
    trainer, init_fn = _stream_trainer(axes, init)
    ckpt = TrainCheckpointer(ckpt_dir)
    loop = ResilientTrainLoop(trainer, ckpt, init_fn, save_every=0)

    def decode(rec):
        row = np.frombuffer(rec["bytes"], np.float32)
        return {"x": row.copy(),
                "y": np.int64(os.path.basename(rec["path"]).split("_")[1])}
    data = (FileSource(os.path.join(corpus, files_by_rank[rank]))
            .map(decode).batch(local_batch))
    try:
        loop.run_dataset(data, total)
    except ValueError as e:
        return str(e)
    finally:
        ckpt.close()
    return None


def shard_defaults(rank, world, mesh_text, x, corpus):
    """Under ``runtime.mesh = mesh_text``: this rank's default
    ``Frame.process_shard()`` rows, ``process_shard=True`` file listing
    and ``FileSource`` paths."""
    from mmlspark_tpu_torch.core.frame import Frame
    from mmlspark_tpu_torch.data.pipeline import FileSource
    from mmlspark_tpu_torch.io.readers import list_binary_entries
    with _Configured(runtime__mesh=mesh_text):
        rows = Frame.from_dict({"x": x}).process_shard().column("x")
        listed = [path for path, _ in
                  list_binary_entries(corpus, process_shard=True)]
        streamed = [r["path"] for r in
                    FileSource(corpus, process_shard=True).iter()]
        share = meshlib.data_shard()
    return {"rows": np.asarray(rows), "listed": listed,
            "streamed": streamed, "share": share}
