"""Rank-side functions of the port's meshed tests.

``mmlspark_tpu_torch.testing.ranks.RankPool`` runs these in gloo rank
processes on the CPU, as ``fn(rank, world, *args)``. This module imports
torch, numpy and the port only (never JAX): the ranks must not load it.
Inputs and results are numpy arrays and plain Python values.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mmlspark_tpu_torch.parallel import collectives
from mmlspark_tpu_torch.parallel import mesh as meshlib
from mmlspark_tpu_torch.parallel import sharding

LM = dict(vocab=64, dim=32, depth=2, heads=4, max_len=16)


def _mesh(axes: Dict[str, int]):
    return meshlib.make_mesh(meshlib.MeshSpec(**axes))


def full_params(module) -> Dict[str, np.ndarray]:
    """Every parameter whole (gathered from the ranks' shards)."""
    return {n: sharding.whole(p, sharding._split_of(p),
                              getattr(p, "_mesh_layout", None)).numpy()
            for n, p in module.named_parameters()}


def mesh_facts(rank, world, axes):
    m = _mesh(axes)
    return {"shape": meshlib.mesh_shape(m),
            "coord": sharding.coordinate(m),
            "names": list(m.mesh_dim_names),
            "block": sharding.batch_block(m),
            "share": sharding.batch_share(m),
            "spans": sharding.mesh_spans_processes(m),
            "cpu": sharding.is_cpu_mesh(m),
            "resolved": meshlib.mesh_shape(meshlib.resolve_mesh(
                ",".join(f"{k}={v}" for k, v in axes.items()))),
            "summary": meshlib.device_count_summary()}


def _lm_module(attention_fn=None, dtype=torch.float32, **arch):
    from mmlspark_tpu_torch.models.zoo.transformer import TransformerLM
    return TransformerLM(**{**LM, **arch}, dtype=dtype,
                         attention_fn=attention_fn)


def _optimizer(name: str, lr: float):
    from mmlspark_tpu_torch.parallel import optim
    return {"adam": optim.adam, "adamw": optim.adamw, "sgd": optim.sgd,
            "lamb": optim.lamb, "adafactor": optim.adafactor}[name](lr)


def lm_train(rank, world, axes: Optional[Dict[str, int]], params,
             batches: List[np.ndarray], opt: str = "adam", lr: float = 1e-2,
             impl: str = "auto", arch: Optional[dict] = None):
    """Train the tiny LM from ``params`` (a port state dict) on
    ``batches`` (global token arrays) with next-token cross entropy on
    the mesh of ``axes`` (None: the launcher's default mesh). Returns the per-step losses
    (the ring's global means), the final whole parameters, and this
    rank's parameter shapes."""
    from mmlspark_tpu_torch.models.zoo.transformer import next_token_loss
    from mmlspark_tpu_torch.parallel.sequence import make_attention_fn
    from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer
    mesh = _mesh(axes) if axes else meshlib.mesh_from_config()
    seq_axis = "seq" if axes and axes.get("seq", 1) > 1 else None
    attn = make_attention_fn(mesh, impl)
    arch = arch or {}

    def init_fn():
        m = _lm_module(attn, **arch)
        m.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in params.items()})
        return m

    def loss_fn(module, batch, gen):
        return next_token_loss(module, batch["tokens"])

    trainer = DistributedTrainer(loss_fn, _optimizer(opt, lr), mesh=mesh,
                                 seq_axis=seq_axis,
                                 device=torch.device("cpu"))
    state = trainer.init(init_fn)
    losses = []
    for b in batches:
        state, m = trainer.train_step(state, trainer.put_batch(
            {"tokens": np.asarray(b)}), 0)
        losses.append(float(m["loss"]))
    return {"losses": losses, "params": full_params(state["module"]),
            "local_shapes": {n: tuple(p.shape) for n, p in
                             state["module"].named_parameters()},
            "host_copies": collectives.host_copies()}


def _cpu():
    return torch.device("cpu")


# -- sharding and the mesh's bookkeeping -------------------------------------

def placed_shards(rank, world, axes, params):
    """Place a state dict of the tiny LM through the trainer; per leaf,
    this rank's slice (start, stop per dim), its local bytes, and the
    module's whole and per-rank bytes."""
    from mmlspark_tpu_torch.observability import memory as devmem
    from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer
    mesh = _mesh(axes)
    trainer = DistributedTrainer(lambda m, b, g: None, _optimizer("sgd", 0.1),
                                 mesh=mesh, device=_cpu())

    def init_fn():
        m = _lm_module()
        m.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in params.items()})
        return m
    module = trainer.init(init_fn)["module"]
    coord = sharding.coordinate(mesh)
    out = {}
    for name, p in module.named_parameters():
        sl = p._mesh_sharding.slices(coord)
        out[name] = {"index": [(s.start, s.stop) for s in sl],
                     "bytes": int(p.numel() * p.element_size()),
                     "whole": np.asarray(params[name])[sl].tobytes()
                     == p.detach().numpy().tobytes()}
    return {"leaves": out, "param_bytes": devmem.param_bytes(module),
            "shard_bytes": devmem.param_shard_bytes(module),
            "projected": devmem.projected_shard_bytes(params, mesh)}


def mesh_codec(rank, world, axes):
    """The serialization codec's dict of a live DeviceMesh."""
    from mmlspark_tpu_torch.core.serialization import _mesh_to_dict
    return _mesh_to_dict(_mesh(axes))


# -- attention ---------------------------------------------------------------

def seq_attention(rank, world, axes, impl, q, k, v, causal, grads=False):
    """This rank's slice of the sequence through ring / Ulysses attention;
    returns the whole output (and, with ``grads``, the whole gradients of
    sum(out**2) with respect to q, k, v), gathered over ``seq``."""
    from mmlspark_tpu_torch.parallel.sequence import make_attention_fn
    mesh = _mesh(axes)
    fn = make_attention_fn(mesh, impl)
    group = sharding.axis_group(mesh, ("seq",))
    local = [torch.from_numpy(np.ascontiguousarray(
        sharding.local_seq(mesh, np.asarray(x), "seq"))).requires_grad_(grads)
        for x in (q, k, v)]
    out = fn(*local, causal=causal)
    res = {"out": collectives.all_gather(out.detach(), 1, group).numpy()}
    if grads:
        (out ** 2).sum().backward()
        res["grads"] = [collectives.all_gather(t.grad, 1, group).numpy()
                        for t in local]
    return res


def ulysses_refusal(rank, world, axes, heads):
    from mmlspark_tpu_torch.parallel.sequence import (make_attention_fn,
                                                      ring_attention)
    mesh = _mesh(axes)
    q = torch.zeros((1, 4, heads, 4))
    try:
        make_attention_fn(mesh, "ulysses")(q, q, q)
    except ValueError as e:
        refused = str(e)
    else:
        refused = None
    return {"refused": refused,
            "auto_is_ring": make_attention_fn(mesh, "auto").func
            is ring_attention}


# -- training ----------------------------------------------------------------

def epoch_cache(rank, world, axes, data, batch, shuffle, seq):
    """A meshed DeviceEpochCache over global ``data``: this rank's batches
    of epochs 0 and 1, and the bytes it uploaded."""
    from mmlspark_tpu_torch.parallel.trainer import DeviceEpochCache
    cache = DeviceEpochCache(data, batch, mesh=_mesh(axes),
                             seq_axis="seq" if seq else None,
                             shuffle=shuffle, seed=3, device=_cpu())
    return {"epochs": [[{k: v.numpy() for k, v in b.items()}
                        for b in cache.batches(e)] for e in (0, 1)],
            "nbytes": cache.nbytes, "local_batch": cache.local_batch,
            "coord": sharding.coordinate(cache.mesh)}


def resnet_train(rank, world, axes, params, images, labels, steps, arch):
    """ResNet data parallel: sgd steps on global batches; the losses, this
    rank's final parameters (numpy, not gathered: they are replicated)."""
    from mmlspark_tpu_torch.models.zoo.resnet import ResNet
    from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer

    def init_fn():
        m = ResNet(**arch)
        m.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in params.items()})
        return m

    def loss_fn(module, batch, gen):
        return F.cross_entropy(module(batch["image"]).float(),
                               batch["label"].long())
    trainer = DistributedTrainer(loss_fn, _optimizer("sgd", 0.05),
                                 mesh=_mesh(axes), device=_cpu())
    state = trainer.init(init_fn)
    losses = []
    for i in range(steps):
        sl = slice(i * len(labels) // steps, (i + 1) * len(labels) // steps)
        state, m = trainer.train_step(state, trainer.put_batch(
            {"image": images[sl], "label": labels[sl]}), 0)
        losses.append(float(m["loss"]))
    return {"losses": losses,
            "params": {n: p.detach().numpy().copy()
                       for n, p in state["module"].named_parameters()}}


def deep_fit(rank, world, mesh_spec, x, y, kwargs, block_rows=None):
    """DeepClassifier fit over ``meshSpec`` on this rank's block-cyclic
    shard of the frame (``process_shard(block_rows=...)``; the whole frame
    when ``block_rows`` is None); the fitted params and final loss."""
    from mmlspark_tpu_torch.core.frame import Frame
    from mmlspark_tpu_torch.train.deep import DeepClassifier
    frame = Frame.from_dict({"features": x, "label": y})
    if block_rows is not None:
        frame = frame.process_shard(block_rows=block_rows)
    model = DeepClassifier(featuresCol="features", labelCol="label",
                           meshSpec=mesh_spec, **kwargs).fit(frame)
    return {"params": model._state["params"],
            "final_loss": float(model._state["final_loss"]),
            "history": model.validation_history}


def _lm_trainer(mesh, opt="adam", lr=1e-2, arch=None, impl="auto"):
    from mmlspark_tpu_torch.models.zoo.transformer import next_token_loss
    from mmlspark_tpu_torch.parallel.sequence import make_attention_fn
    from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer
    shape = meshlib.mesh_shape(mesh)
    seq_axis = "seq" if shape["seq"] > 1 else None
    attn = make_attention_fn(mesh, impl)
    trainer = DistributedTrainer(
        lambda m, b, g: next_token_loss(m, b["tokens"]),
        _optimizer(opt, lr), mesh=mesh, seq_axis=seq_axis, device=_cpu())
    return trainer, (lambda: _lm_module(attn, **(arch or {})))


def checkpoint_across(rank, world, params, batches, directory, shapes):
    """Train on the first mesh shape, save, then for each next shape
    restore (the values must come back whole and equal), step once and
    save again. Returns, per shape, the restored whole params, each
    rank's local shapes, and the losses."""
    from mmlspark_tpu_torch.parallel.checkpoint import TrainCheckpointer
    out = []
    state = None
    for i, shape in enumerate(shapes):
        mesh = meshlib.make_mesh(meshlib.parse_mesh_shape(shape))
        trainer, make = _lm_trainer(mesh)

        def init_fn():
            m = make()
            m.load_state_dict({k: torch.from_numpy(np.array(v))
                               for k, v in params.items()})
            return m
        ckpt = TrainCheckpointer(directory)
        state = trainer.init(init_fn) if i == 0 else \
            ckpt.restore(trainer, init_fn)
        restored = full_params(state["module"])
        losses = []
        for b in batches[i]:
            state, m = trainer.train_step(
                state, trainer.put_batch({"tokens": np.asarray(b)}), 0)
            losses.append(float(m["loss"]))
        ckpt.save(state, wait=True)
        ckpt.close()
        out.append({"restored": restored, "losses": losses,
                    "local_shapes": {n: tuple(p.shape) for n, p in
                                     state["module"].named_parameters()},
                    "step": int(state["step"])})
    return out


def reshard_run(rank, world, params, batches, directory, first, then,
                at_step):
    """ResilientTrainLoop.run from mesh ``first``, with a reshard to
    ``then`` requested while step ``at_step`` runs (honoured at the next
    step boundary); the final whole params, the final trainer's mesh
    shape and the step."""
    from mmlspark_tpu_torch.parallel.checkpoint import TrainCheckpointer
    from mmlspark_tpu_torch.reliability.resilient import ResilientTrainLoop

    def init_fn():
        m = _lm_module()
        m.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in params.items()})
        return m
    factory = (lambda mesh: _lm_trainer(mesh)[0])  # noqa: E731
    loop = ResilientTrainLoop(
        factory(meshlib.make_mesh(meshlib.parse_mesh_shape(first))),
        TrainCheckpointer(directory), init_fn, save_every=0,
        trainer_factory=factory)

    def batch_fn(step):
        if then and step == at_step:
            loop.reshard_to(then)
        return {"tokens": np.asarray(batches[step - 1])}
    state = loop.run(batch_fn, len(batches))
    loop.ckpt.close()
    return {"mesh": meshlib.mesh_shape(loop.trainer.mesh),
            "params": full_params(state["module"]),
            "local_shapes": {n: tuple(p.shape) for n, p in
                             state["module"].named_parameters()},
            "step": int(state["step"])}


def card_ulysses(rank, world, q, k, v, causal):
    """Ulysses on two ranks sharing the card (gloo): each rank's slice of
    the sequence, K3 on its half of the heads; the whole output gathered
    (as fp32) and this rank's K3 launches."""
    from mmlspark_tpu_torch import kernels
    from mmlspark_tpu_torch.parallel.sequence import make_attention_fn
    card = torch.device("cuda", 0)
    torch.cuda.set_device(card)
    kernels.build_all()
    mesh = _mesh({"data": 1, "seq": world})
    local = [torch.from_numpy(np.ascontiguousarray(
        sharding.local_seq(mesh, np.asarray(x), "seq"))).to(card)
        .to(torch.bfloat16) for x in (q, k, v)]
    kernels.reset_launches()
    out = make_attention_fn(mesh, "ulysses")(*local, causal=causal)
    torch.cuda.synchronize()
    launches = {kk.name: kk.launches for kk in kernels.KERNELS}
    whole = collectives.all_gather(out.float(), 1,
                                   sharding.axis_group(mesh, ("seq",)))
    return {"out": whole.cpu().numpy(), "launches": launches,
            "host_copies": collectives.host_copies()}


def vit_train(rank, world, axes, params, images, labels):
    """vit_tiny (fp32) on the mesh: sgd steps on global batches; the
    losses, the whole final params and this rank's shapes."""
    from mmlspark_tpu_torch.models.zoo import build_model
    from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer

    def init_fn():
        m = build_model("vit_tiny", num_classes=10, image_size=16, patch=4,
                        dtype="float32")["module"]
        m.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in params.items()})
        return m
    trainer = DistributedTrainer(
        lambda m, b, g: F.cross_entropy(m(b["image"]).float(), b["label"]),
        _optimizer("sgd", 0.05), mesh=_mesh(axes), device=_cpu())
    state = trainer.init(init_fn)
    losses = []
    for x, y in zip(images, labels):
        state, m = trainer.train_step(state, trainer.put_batch(
            {"image": x, "label": y}), 0)
        losses.append(float(m["loss"]))
    return {"losses": losses, "params": full_params(state["module"]),
            "local_shapes": {n: tuple(p.shape) for n, p in
                             state["module"].named_parameters()}}


def abstract_layouts(rank, world, axes, params, opt):
    """``DistributedTrainer.abstract_state`` of the tiny LM on the mesh of
    ``axes`` against the trainer's placement: every abstract tensor on the
    meta device; each parameter's ``ParamSharding`` (spec, shard shape)
    equal to ``init``'s and its slice of ``params`` equal to the placed
    shard; after one step, each optimizer state tensor's local shape
    equal to its abstract sharding's shard shape (the whole shape where
    replicated). Returns the mismatches."""
    from mmlspark_tpu_torch.models.zoo.transformer import next_token_loss
    from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer
    mesh = _mesh(axes)

    def init_fn():
        m = _lm_module()
        m.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in params.items()})
        return m

    trainer = DistributedTrainer(
        lambda m, b, g: next_token_loss(m, b["tokens"]),
        _optimizer(opt, 1e-2), mesh=mesh, device=_cpu())
    abstract, shardings = trainer.abstract_state(init_fn)
    tensors = [*abstract["params"].values(), abstract["step"],
               *(t for st in abstract["opt_state"].values()
                 for t in st.values())]
    all_meta = all(t.device.type == "meta" for t in tensors)
    state = trainer.init(init_fn)
    placed = trainer.state_sharding_spec()
    coord = sharding.coordinate(mesh)
    params_mismatch = []
    for name, p in state["module"].named_parameters():
        sh, want = shardings["params"][name], placed[name]
        local = np.asarray(params[name])[sh.slices(coord)]
        if (sh.spec != want.spec or sh.shard_shape() != tuple(p.shape)
                or tuple(abstract["params"][name].shape) != sh.shape
                or not np.array_equal(local, p.detach().numpy())):
            params_mismatch.append(name)
    tokens = np.random.default_rng(rank).integers(
        1, LM["vocab"], (4, LM["max_len"])).astype(np.int32)
    trainer.train_step(state, trainer.put_batch({"tokens": tokens}), 0)
    opt_mismatch = []
    named = dict(state["module"].named_parameters())
    for name, st in abstract["opt_state"].items():
        live = state["optimizer"].torch.state[named[name]]
        for key, t in st.items():
            sh = shardings["opt_state"][name][key]
            want = sh.shard_shape() if sh is not None else tuple(t.shape)
            if tuple(live[key].shape) != want:
                opt_mismatch.append((name, key))
    return {"all_meta": all_meta, "params_mismatch": params_mismatch,
            "opt_mismatch": opt_mismatch,
            "sharded": sum(sh.sharded
                           for sh in shardings["params"].values())}


def step_spans(rank, world, axes):
    """One data-parallel step of a linear model with the span collector
    on: this rank's collected spans as (name, parent's name, attrs)."""
    from mmlspark_tpu_torch.observability import spans
    from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer
    trainer = DistributedTrainer(
        lambda m, b, g: ((m(b["x"]) - b["y"]) ** 2).mean(),
        _optimizer("sgd", 0.1), mesh=_mesh(axes), device=_cpu())
    state = trainer.init(lambda: torch.nn.Linear(4, 2))
    rng = np.random.default_rng(0)
    batch = trainer.put_batch(
        {"x": rng.normal(size=(8, 4)).astype(np.float32),
         "y": rng.normal(size=(8, 2)).astype(np.float32)})
    spans.collect_start()
    try:
        trainer.train_step(state, batch, 0)
    finally:
        got, _ = spans.collect_stop()
    names = {s["span_id"]: s["name"] for s in got}
    return [(s["name"], names.get(s["parent_id"]), s["attrs"]) for s in got]
