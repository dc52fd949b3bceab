"""Rank-side functions of the port's pipeline, expert and embedding tests.

``mmlspark_tpu_torch.testing.ranks.RankPool`` runs these in gloo rank
processes on the CPU, as ``fn(rank, world, *args)``. Like
``torch_mesh_ranks.py`` this module imports torch, numpy and the port
only (never JAX); inputs and results are numpy arrays and plain values.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from mmlspark_tpu_torch.parallel import collectives
from mmlspark_tpu_torch.parallel import mesh as meshlib
from mmlspark_tpu_torch.parallel import sharding

from torch_mesh_ranks import _optimizer, full_params

CPU = torch.device("cpu")


def _mesh(axes: Dict[str, int]):
    return meshlib.make_mesh(meshlib.MeshSpec(**axes))


def _load(module, params):
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in params.items()})
    return module


def _whole_grads(module) -> Dict[str, np.ndarray]:
    """Every parameter's gradient whole (gathered from the shards)."""
    return {n: sharding.whole(p.grad, sharding._split_of(p),
                              getattr(p, "_mesh_layout", None)).numpy()
            for n, p in module.named_parameters() if p.grad is not None}


# -- the MoE LM --------------------------------------------------------------

def _moe_loss(module, tokens):
    from mmlspark_tpu_torch.models.zoo.moe import moe_aux_loss
    from mmlspark_tpu_torch.models.zoo.transformer import next_token_loss
    return next_token_loss(module, tokens) + 0.01 * moe_aux_loss(module)


def _moe_trainer(axes, arch, impl, opt="sgd", lr=0.0):
    from mmlspark_tpu_torch.models.zoo import build_model
    from mmlspark_tpu_torch.parallel.sequence import make_attention_fn
    from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer
    mesh = _mesh(axes)
    seq = "seq" if axes.get("seq", 1) > 1 else None
    attn = make_attention_fn(mesh, impl)
    trainer = DistributedTrainer(lambda m, b, g: _moe_loss(m, b["tokens"]),
                                 _optimizer(opt, lr), mesh=mesh,
                                 seq_axis=seq, device=CPU)

    def make():
        return build_model("transformer_lm_moe_tiny", attention_fn=attn,
                           **arch)["module"]
    return trainer, make


def moe_step(rank, world, axes, params, tokens, arch, impl="full"):
    """One forward and backward of the MoE LM (``next_token_loss`` + 0.01
    x ``moe_aux``) on the mesh of ``axes``: the whole logits (gathered
    over the batch and sequence ranks, and over the vocabulary's ranks
    when ``tensor`` splits it), the global loss, the ``moe_aux``
    this rank computed, the whole gradients of the global mean loss, the
    first MoE block's gate indices and slot positions of this rank's
    tokens, and this rank's shapes of the expert banks."""
    trainer, make = _moe_trainer(axes, arch, impl)
    state = trainer.init(lambda: _load(make(), params))
    module = state["module"]
    for m in module.modules():
        if hasattr(m, "record_routing"):
            m.record_routing = True
    batch = trainer.put_batch({"tokens": np.asarray(tokens)})
    loss = trainer._forward_backward(module, batch, None)
    grads = _whole_grads(module)
    with torch.no_grad(), trainer.mesh_context():
        logits, inters = module.forward_with_intermediates(batch["tokens"])
    layout = trainer.layout
    logits = collectives.all_gather(logits, 1, layout.group("seq")) \
        if layout.seq_axis else logits
    logits = collectives.all_gather(logits, 0,
                                    layout.group(*layout.batch_axes))
    if module._vocab is not None:
        logits = collectives.all_gather(logits, 2, module._vocab)
    moe = module.block1.ffn
    return {"logits": logits.numpy(), "loss": float(loss),
            "moe_aux": float(inters["moe_aux"]), "grads": grads,
            "gate_idx": moe.routing["gate_idx"].numpy(),
            "position": moe.routing["position"].numpy(),
            "up_shape": tuple(moe.experts_up.shape),
            "down_shape": tuple(moe.experts_down.shape)}


def moe_train(rank, world, axes, params, batches, arch, impl="full",
              opt="adamw", lr=1e-3):
    """adamw steps of the MoE LM on the mesh: the per-step global losses,
    the whole final parameters and this rank's expert-bank shapes."""
    trainer, make = _moe_trainer(axes, arch, impl, opt, lr)
    state = trainer.init(lambda: _load(make(), params))
    losses = []
    for b in batches:
        state, m = trainer.train_step(state, trainer.put_batch(
            {"tokens": np.asarray(b)}), 0)
        losses.append(float(m["loss"]))
    from mmlspark_tpu_torch.observability import memory as devmem
    module = state["module"]
    moe = module.block1.ffn
    return {"losses": losses, "params": full_params(module),
            "up_shape": tuple(moe.experts_up.shape),
            "shard_bytes": devmem.param_shard_bytes(module),
            "projected": devmem.projected_shard_bytes(
                make(), meshlib.mesh_shape(trainer.mesh)),
            "host_copies": collectives.host_copies()}


# -- pipelines ---------------------------------------------------------------

def _residual_mlp(p, x):
    """The JAX pipeline tests' stage: one residual MLP (JAX layouts)."""
    return x + torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"]


def _tanh_stage(p, x):
    """The multi-process test's stage: x + tanh(x @ w)."""
    return x + torch.tanh(x @ p["w"])


STAGES = {"residual_mlp": _residual_mlp, "tanh": _tanh_stage}


def _tree(tree, grad=False):
    if isinstance(tree, dict):
        return {k: _tree(v, grad) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).requires_grad_(grad)


def _batch_group(mesh):
    return sharding.axis_group(mesh, sharding.active_batch_axes(mesh) or ())


def pipe_apply(rank, world, axes, stage, stacked, x, n_micro, grads=False):
    """``pipeline_apply`` of the whole stacked tree on this rank's rows of
    the global ``x``: the whole output (gathered over the data ranks)
    and, with ``grads``, the loss over the global batch (the mean of
    out**2) and the whole gradients of the stacked leaves (summed over
    the data ranks)."""
    from mmlspark_tpu_torch.parallel.pipeline_parallel import pipeline_apply
    mesh = _mesh(axes)
    params = _tree(stacked, grads)
    xl = torch.from_numpy(sharding.local_rows(mesh, np.asarray(x)))
    out = pipeline_apply(STAGES[stage], params, xl, mesh, n_micro)
    group = _batch_group(mesh)
    res = {"out": collectives.all_gather(out.detach(), 0, group).numpy()}
    if grads:
        value = (out ** 2).sum() / out.numel() / \
            sharding.batch_share(mesh)[1]
        value.backward()
        res["loss"] = float(collectives.all_reduce(value.detach(), group))
        flat = {}

        def walk(prefix, node):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(f"{prefix}{k}.", v)
                else:
                    flat[prefix + k] = collectives.all_reduce(
                        v.grad, group).numpy()
        walk("", params)
        res["grads"] = flat
    return res


def pipe_refusal(rank, world, axes, stacked, rows, dim, n_micro):
    """The ValueError (message) of a pipeline over the global batch of
    ``rows`` rows, or None."""
    from mmlspark_tpu_torch.parallel.pipeline_parallel import pipeline_apply
    mesh = _mesh(axes)
    try:
        xl = torch.from_numpy(sharding.local_rows(
            mesh, np.zeros((rows, dim), np.float32)))
        pipeline_apply(_residual_mlp, _tree(stacked), xl, mesh, n_micro)
    except ValueError as e:
        return str(e)
    return None


class PipeMLP(torch.nn.Module):
    """test_mesh2d's pipelined residual-MLP body (``stages``, its stage
    leaves in torch layouts) and an out-of-pipeline head."""

    def __init__(self, host):
        from mmlspark_tpu_torch.parallel.pipeline_parallel import StageStack
        super().__init__()
        self.stages = StageStack(
            {"mlp_up": {"weight": np.array(host["up"])},
             "mlp_down": {"weight": np.array(host["down"])}})
        self.head = torch.nn.Linear(host["head"].shape[1], 1, bias=False)
        with torch.no_grad():
            self.head.weight.copy_(torch.from_numpy(np.array(host["head"])))


def _pipe_stage(p, x):
    h = torch.tanh(x @ p["mlp_up"]["weight"].T)
    return x + h @ p["mlp_down"]["weight"].T


def pipe_loss(module, batch, n_micro=2):
    h = module.stages(_pipe_stage, batch["x"], n_micro)
    pred = module.head(h)[:, 0]
    return ((pred - batch["y"]) ** 2).mean()


def _pipe_trainer(mesh, opt, lr, n_micro):
    from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer
    return DistributedTrainer(lambda m, b, g: pipe_loss(m, b, n_micro),
                              _optimizer(opt, lr), mesh=mesh,
                              rules=sharding.pipeline_stacked_rules(),
                              device=CPU)


def pipe_train(rank, world, shape, host, batches, opt="adam", lr=1e-2,
               n_micro=2):
    """The pipelined MLP trained on the mesh of ``shape`` (``DxTxP``
    shorthand, or an axis dict): the losses, the whole final params,
    this rank's shapes and placements, its resident and projected
    bytes."""
    from mmlspark_tpu_torch.observability import memory as devmem
    mesh = meshlib.make_mesh(meshlib.parse_mesh_shape(shape)
                             if isinstance(shape, str)
                             else meshlib.MeshSpec(**shape))
    trainer = _pipe_trainer(mesh, opt, lr, n_micro)
    state = trainer.init(lambda: PipeMLP(host))
    losses = []
    for b in batches:
        state, m = trainer.train_step(state, trainer.put_batch(b), 0)
        losses.append(float(m["loss"]))
    module = state["module"]
    return {"losses": losses, "params": full_params(module),
            "local_shapes": {n: tuple(p.shape) for n, p in
                             module.named_parameters()},
            "specs": {n: sh.spec for n, sh in
                      trainer.state_sharding_spec().items()},
            "shard_bytes": devmem.param_shard_bytes(module),
            "param_bytes": devmem.param_bytes(module),
            "projected": devmem.projected_shard_bytes(
                PipeMLP(host), mesh, sharding.pipeline_stacked_rules()),
            "host_copies": collectives.host_copies()}


# -- embedding tables --------------------------------------------------------

def _tensor_group(mesh):
    return sharding.axis_group(mesh, ("tensor",))


def _rows_of(mesh, arr):
    """This rank's row shard (over ``tensor``) of a whole host table."""
    t = sharding.tensor_axis_size(mesh)
    step = arr.shape[0] // t
    me = sharding.coordinate(mesh)["tensor"] if t > 1 else 0
    return np.ascontiguousarray(arr[me * step:(me + 1) * step])


def embed_lookup(rank, world, axes, table, ids, w, fused=True):
    """The fused lookup of this rank's row shard and block of the batch;
    the bags gathered over the data ranks."""
    from mmlspark_tpu_torch.embed.tables import make_fused_lookup
    from mmlspark_tpu_torch.utils import config
    mesh = _mesh(axes)
    config.set("embed.fused_lookup", fused)
    try:
        lookup = make_fused_lookup(mesh)
        tab = torch.from_numpy(_rows_of(mesh, table) if fused else table)
        bags = lookup(tab, torch.from_numpy(sharding.local_rows(mesh, ids)),
                      torch.from_numpy(sharding.local_rows(mesh, w)))
    finally:
        config.unset("embed.fused_lookup")
    return collectives.all_gather(bags, 0, _batch_group(mesh)).numpy()


def embed_grad(rank, world, axes, table, ids, w, gbags, fused=True):
    """The sparse table gradient of this rank's shard from its block of
    the batch, gathered whole over ``tensor``; and the collectives' bytes
    by op it moved."""
    from mmlspark_tpu_torch.embed.tables import sparse_table_grads
    from mmlspark_tpu_torch.utils import config
    mesh = _mesh(axes)
    config.set("embed.fused_lookup", fused)
    collectives.reset_traffic()
    try:
        tab = torch.from_numpy(_rows_of(mesh, table) if fused else table)
        g = sparse_table_grads(mesh, tab,
                               torch.from_numpy(sharding.local_rows(mesh, ids)),
                               torch.from_numpy(sharding.local_rows(mesh, w)),
                               torch.from_numpy(sharding.local_rows(mesh,
                                                                    gbags)))
    finally:
        config.unset("embed.fused_lookup")
    traffic = collectives.traffic()
    if fused:
        g = collectives.all_gather(g, 0, _tensor_group(mesh))
    return {"grad": g.numpy(), "traffic": traffic}


def embed_autograd(rank, world, axes, table, ids, w, target):
    """d/dtable of sum((bags - target)**2) over the GLOBAL batch through
    ``make_bag_lookup``: each rank's loss is its rows' sum, the sparse
    gradient sums every data rank's contributions; gathered whole."""
    from mmlspark_tpu_torch.embed.tables import make_bag_lookup
    mesh = _mesh(axes)
    tab = torch.from_numpy(_rows_of(mesh, table)).requires_grad_()
    bags = make_bag_lookup(mesh)(
        tab, torch.from_numpy(sharding.local_rows(mesh, ids)),
        torch.from_numpy(sharding.local_rows(mesh, w)))
    ((bags - torch.from_numpy(sharding.local_rows(mesh, target))) ** 2
     ).sum().backward()
    return collectives.all_gather(tab.grad, 0, _tensor_group(mesh)).numpy()


def collection_round(rank, world, axes, specs, seed, batch, gbags, lr):
    """init -> place -> lookup -> grads -> sgd_update of an
    EmbeddingCollection on the mesh (None: one device), the batch this
    rank's block of the global one: the updated tables whole, the bags
    gathered, this rank's resident bytes and the logical bytes."""
    from mmlspark_tpu_torch.embed.tables import (EmbeddingCollection,
                                                 EmbeddingTable)
    mesh = _mesh(axes) if axes else None
    coll = EmbeddingCollection([EmbeddingTable(*s) for s in specs],
                               mesh=mesh, device=CPU)
    tables = coll.place(coll.init(seed))
    local = {k: (torch.from_numpy(sharding.local_rows(mesh, v[0])
                                  if mesh else v[0]),
                 torch.from_numpy(sharding.local_rows(mesh, v[1])
                                  if mesh else v[1]))
             for k, v in batch.items()}
    g = {k: torch.from_numpy(sharding.local_rows(mesh, v) if mesh else v)
         for k, v in gbags.items()}
    bags = coll.lookup(tables, local)
    new = coll.sgd_update(tables, coll.grads(tables, local, g), lr)
    group = _tensor_group(mesh) if mesh else None
    bgroup = _batch_group(mesh) if mesh else None
    return {"tables": {k: collectives.all_gather(v, 0, group).numpy()
                       for k, v in new.items()},
            "bags": {k: collectives.all_gather(v, 0, bgroup).numpy()
                     for k, v in bags.items()},
            "resident": sum(v.numel() * v.element_size()
                            for v in tables.values()),
            "logical": coll.logical_bytes()}


def _dlrm_loss(module, batch):
    import torch.nn.functional as F
    return F.binary_cross_entropy_with_logits(module(batch["x"])[:, 0],
                                              batch["y"])


def _dlrm_trainer(mesh, opt, lr):
    from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer
    return DistributedTrainer(lambda m, b, g: _dlrm_loss(m, b),
                              _optimizer(opt, lr), mesh=mesh, device=CPU)


def _dlrm(params, kw):
    from mmlspark_tpu_torch.models.zoo import build_model
    return _load(build_model("recommender_dlrm", **kw)["module"], params)


def dlrm_train(rank, world, shape, params, batches, kw, opt="adam", lr=1e-2):
    """The DLRM trained on the mesh of ``shape`` (``DxT``): the losses,
    the whole final params, each leaf's spec and this rank's shapes, and
    the collectives' traffic of the steps."""
    from mmlspark_tpu_torch.observability import memory as devmem
    mesh = meshlib.make_mesh(meshlib.parse_mesh_shape(shape))
    trainer = _dlrm_trainer(mesh, opt, lr)
    state = trainer.init(lambda: _dlrm(params, kw))
    collectives.reset_traffic()
    losses = []
    for b in batches:
        state, m = trainer.train_step(state, trainer.put_batch(b), 0)
        losses.append(float(m["loss"]))
    traffic = collectives.traffic()
    module = state["module"]
    return {"losses": losses, "params": full_params(module),
            "specs": {n: sh.spec for n, sh in
                      trainer.state_sharding_spec().items()},
            "local_shapes": {n: tuple(p.shape) for n, p in
                             module.named_parameters()},
            "summed": list(module.summed_grads), "traffic": traffic,
            "shard_bytes": devmem.param_shard_bytes(module),
            "projected": devmem.projected_shard_bytes(_dlrm(params, kw),
                                                      mesh)}


def _trainer_of(kind, shape, kw):
    """(trainer, init_fn) of a model of this slice on a mesh: ``shape``
    is ``DxTxP`` shorthand or an axis dict."""
    mesh = meshlib.make_mesh(meshlib.parse_mesh_shape(shape)
                             if isinstance(shape, str)
                             else meshlib.MeshSpec(**shape))
    if kind == "dlrm":
        return _dlrm_trainer(mesh, "adam", 1e-2), \
            (lambda: _dlrm(kw["params"], kw["arch"]))
    if kind == "pipe":
        return _pipe_trainer(mesh, "adam", 1e-2, 2), \
            (lambda: PipeMLP(kw["host"]))
    trainer, make = _moe_trainer(
        meshlib.mesh_shape(mesh), kw["arch"], "full", "adam", 1e-2)
    return trainer, (lambda: _load(make(), kw["params"]))


def checkpoint_shapes(rank, world, kind, kw, batches, directory, shapes):
    """Train on the first mesh shape, save; restore on each next shape
    (the whole params must equal the save), step, save. Per shape: the
    restored and the saved whole params, the losses, this rank's shapes
    and the leaves' specs."""
    from mmlspark_tpu_torch.parallel.checkpoint import TrainCheckpointer
    out = []
    for i, shape in enumerate(shapes):
        trainer, init_fn = _trainer_of(kind, shape, kw)
        ckpt = TrainCheckpointer(directory)
        state = trainer.init(init_fn) if i == 0 else \
            ckpt.restore(trainer, init_fn)
        # copies: a replicated leaf's array shares the live parameter
        restored = {k: v.copy() for k, v in
                    full_params(state["module"]).items()}
        losses = []
        for b in batches[i]:
            state, m = trainer.train_step(state, trainer.put_batch(b), 0)
            losses.append(float(m["loss"]))
        ckpt.save(state, wait=True)
        ckpt.close()
        out.append({"restored": restored, "losses": losses,
                    "saved": full_params(state["module"]),
                    "step": int(state["step"]),
                    "local_shapes": {n: tuple(p.shape) for n, p in
                                     state["module"].named_parameters()},
                    "specs": {n: sh.spec for n, sh in
                              trainer.state_sharding_spec().items()}})
    return out


def pipe_reshard(rank, world, host, batches, directory, first, plan):
    """ResilientTrainLoop.run of the pipelined MLP from mesh ``first``,
    resharding to ``shape`` while step ``at`` runs for each ``(at,
    shape)`` of ``plan``: the final whole params, mesh shape, step and
    this rank's stage-leaf shape."""
    from mmlspark_tpu_torch.parallel.checkpoint import TrainCheckpointer
    from mmlspark_tpu_torch.reliability.resilient import ResilientTrainLoop

    def factory(mesh):
        return _pipe_trainer(mesh, "adam", 1e-2, 2)
    loop = ResilientTrainLoop(
        factory(meshlib.make_mesh(meshlib.parse_mesh_shape(first))),
        TrainCheckpointer(directory), lambda: PipeMLP(host), save_every=0,
        trainer_factory=factory)
    at = dict(plan)

    def batch_fn(step):
        if step in at:
            loop.reshard_to(at[step])
        return batches[step - 1]
    state = loop.run(batch_fn, len(batches))
    loop.ckpt.close()
    return {"mesh": meshlib.mesh_shape(loop.trainer.mesh),
            "params": full_params(state["module"]),
            "up_shape": tuple(state["module"].stages.mlp_up.weight.shape),
            "step": int(state["step"])}


# -- on the card (two ranks sharing it over gloo) -----------------------------

def _card():
    card = torch.device("cuda", 0)
    torch.cuda.set_device(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def card_embed(rank, world, table, ids, w, gbags):
    """The fused lookup and the sparse gradient at tensor 2 on the card:
    the bags and the whole gradient (host arrays) and the host copies."""
    from mmlspark_tpu_torch.embed.tables import (make_fused_lookup,
                                                 sparse_table_grads)
    card = _card()
    mesh = _mesh({"data": 1, "tensor": world})
    collectives.reset_host_copies()
    tab = torch.from_numpy(_rows_of(mesh, table)).to(card)
    idt, wt = torch.from_numpy(ids).to(card), torch.from_numpy(w).to(card)
    bags = make_fused_lookup(mesh)(tab, idt, wt)
    grad = sparse_table_grads(mesh, tab, idt, wt,
                              torch.from_numpy(gbags).to(card))
    grad = collectives.all_gather(grad, 0, _tensor_group(mesh))
    return {"bags": bags.cpu().numpy(), "grad": grad.cpu().numpy(),
            "host_copies": collectives.host_copies()}


def card_pipe(rank, world, stacked, x, n_micro):
    """``pipeline_apply`` at pipe 2 on the card (fp32): the output, the
    loss's gradients (mean(out**2)) and the host copies of the hops."""
    from mmlspark_tpu_torch.parallel.pipeline_parallel import pipeline_apply
    card = _card()
    mesh = _mesh({"data": 1, "pipe": world})
    collectives.reset_host_copies()
    params = {k: torch.from_numpy(np.array(v)).to(card).requires_grad_()
              for k, v in stacked.items()}
    out = pipeline_apply(_residual_mlp, params, torch.from_numpy(x).to(card),
                         mesh, n_micro)
    (out ** 2).mean().backward()
    return {"out": out.detach().cpu().numpy(),
            "grads": {k: v.grad.cpu().numpy() for k, v in params.items()},
            "host_copies": collectives.host_copies()}


def card_moe(rank, world, params, tokens, arch):
    """The MoE LM's logits at expert 2 on the card (fp32): each rank
    holds half the experts of every bank."""
    from mmlspark_tpu_torch import kernels
    from mmlspark_tpu_torch.models.zoo import build_model
    from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer
    card = _card()
    kernels.build_all()
    mesh = _mesh({"data": 1, "expert": world})
    trainer = DistributedTrainer(lambda m, b, g: None, _optimizer("sgd", 0.0),
                                 mesh=mesh, device=card)
    module = trainer.init(lambda: _load(build_model(
        "transformer_lm_moe_tiny", **arch)["module"], params))["module"]
    kernels.reset_launches()
    with torch.no_grad(), trainer.mesh_context():
        logits = module(torch.from_numpy(tokens).to(card).long())
    return {"logits": logits.cpu().numpy(),
            "experts": int(module.block1.ffn.experts_up.shape[0]),
            "launches": {k.name: k.launches for k in kernels.KERNELS}}
