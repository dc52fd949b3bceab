"""Training: ``DistributedTrainer.train_step`` with SGD and momentum over a
``DeviceEpochCache`` of seeded uint8 images, normalized inside the loss by
``make_preprocess_fn`` (K1 on a card). On several ranks (a cell on several
cards) the trainer and the cache take the launcher's data-parallel mesh:
each rank holds its block of every global batch, and the gradients are
all-reduced; the ranks agree to stop at the trainer's ring reads.

Traffic keys: ``epoch_images``; ``batch`` (the global batch);
``lr``; ``momentum``; ``normalize`` {mean, std}; ``warm_steps`` after the
three compared ones; ``reference_chunk`` (rows a reference pass takes).
Set-up builds one trainer and state, drives it through the epoch's first
three batches with the window's own call and feed, and hands it on to the
window. End-to-end: ``train_images_per_s``, every image of the window's
steps over the window, which ends when the device has finished them.
``correct``: the three steps against the float32 reference from the same
weights and batches: each step's loss (``loss_gap``), each leaf's first
gradient as SGD's momentum buffer holds it after step 1
(``grad_norm_gap``), each leaf's change over the three steps
(``change_norm_gap``, leaves whose reference gradient is under a
thousandth of the median leaf's left out)."""
import numpy as np
import torch
import torch.nn.functional as F

from cardbench import gen, weights
from cardbench.compare import leaf_norms, loss_gap, norm_gap
from cardbench.harness import free_device, rank, within
from cardbench.lanes import now, peak_bytes, sync, trace_start
from cardbench.reference.drive import train_steps

COMPARED_STEPS = 3
# a leaf whose reference gradient is under this share of the median
# leaf's moves by round-off alone (a key bias under softmax)
STILL_LEAF = 1e-3


def run(ctx):
    from mmlspark_tpu_torch.models.zoo import build_model
    from mmlspark_tpu_torch.ops.preprocess import make_preprocess_fn
    from mmlspark_tpu_torch.parallel.optim import sgd
    from mmlspark_tpu_torch.parallel.trainer import (
        DeviceEpochCache, DistributedTrainer,
    )
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    s, batch = cfg["image_size"], tr["batch"]
    shape = (s, s, cfg["in_channels"])
    params = weights.make(cfg, ctx.seed, dev)
    ctx.mark("weights")
    images = gen.image_pool(tr["epoch_images"], shape, ctx.seed, dev)
    labels = gen.labels(tr["epoch_images"], cfg["num_classes"], ctx.seed)
    ctx.mark("inputs")
    norm = tr["normalize"]
    pre = make_preprocess_fn(shape, norm["mean"], norm["std"])

    def loss_fn(module, b, g):
        logits = module(pre(b["image"])).float()
        return F.cross_entropy(logits, b["label"].long())

    module = build_model(cfg["architecture"], **cfg["arch_args"])["module"]
    module.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()},
                           strict=True)
    ctx.mark("module")
    trainer = DistributedTrainer(loss_fn, sgd(tr["lr"], momentum=tr["momentum"]))
    state = trainer.init(lambda: module)
    ctx.mark("trainer")
    mesh = trainer.mesh
    world = 1 if mesh is None else mesh.size()
    cache = DeviceEpochCache({"image": images.reshape(len(images), -1),
                              "label": labels}, batch, mesh=mesh)

    def batches():
        while True:
            yield from cache.batches(0)
    feed = batches()
    ctx.mark("epoch_cache")

    named = dict(state["module"].named_parameters())
    names = [n for n in params if n in named]
    start = [named[n].detach().clone() for n in names]
    losses = []
    for step in range(COMPARED_STEPS):
        state, m = trainer.train_step(state, next(feed), 1)
        losses.append(m["loss"])
        if step == 0:
            # SGD's first momentum buffer is the gradient it was given;
            # a step that never reached the optimizer left none
            opt = state["optimizer"].torch
            bufs = [opt.state[named[n]].get("momentum_buffer") for n in names]
            grad_norms = leaf_norms([torch.zeros(()) if b is None else b
                                     for b in bufs])
            del bufs
    change = leaf_norms([named[n].detach() - p0 for n, p0 in zip(names, start)])
    del start
    losses = torch.stack(losses).float().cpu().tolist()
    ctx.mark("compared_steps")
    for _ in range(tr["warm_steps"]):
        state, m = trainer.train_step(state, next(feed), 1)
    trainer.flush_metrics()
    ctx.tracer.warm()
    sync(dev)
    ctx.mark("warm")

    span = ctx.tracer.span
    t_on = trace_start(ctx)
    # one card stops on its own clock; ranks vote at the ring reads, where
    # the step syncs anyway, so that all stop after the same step
    every = 1 if mesh is None else trainer.flush_steps()
    tracing, record, steps, traced = False, None, 0, 0
    t0 = ctx.window_opens()
    while True:
        if ctx.trace and not tracing and now() - t0 >= t_on:
            ctx.tracer.start()
            tracing = True
        with span("next_batch"):
            b = next(feed)
        with span("train_step"):
            state, m = trainer.train_step(state, b, 1)
        steps += 1
        traced += tracing
        if steps % every:
            continue
        done = now() - t0 >= ctx.seconds
        if mesh is not None:
            with span("agree"):
                done = _any_rank(done, dev)
        if done:
            break
    with span("drain"):
        final = trainer.flush_metrics()
    elapsed = now() - t0
    if tracing:
        record = ctx.tracer.stop()
    peak = peak_bytes(dev)
    last_loss = float(np.asarray(final["loss"])[-1]) if final else float("nan")
    del trainer, state, module, named, cache, feed, b, m
    free_device()
    if mesh is not None:
        import torch.distributed as dist
        mine = {"peak": peak, "busy_s": record["busy_s"][0] if record else None,
                "nccl_s": _nccl_s(record) if record else None}
        ranks = [None] * world
        dist.all_gather_object(ranks, mine)
        peak = max(r["peak"] for r in ranks)
        if rank() != 0:
            dist.barrier()
            return None
        if record is not None:
            record["busy_s"] = [r["busy_s"] for r in ranks]

    u8 = images[:COMPARED_STEPS * batch]
    ref = train_steps(cfg, params, [(u8[i * batch:(i + 1) * batch],
                                     labels[i * batch:(i + 1) * batch])
                                    for i in range(COMPARED_STEPS)],
                      tr["lr"], tr["momentum"], norm["mean"], norm["std"],
                      dev, chunk=tr.get("reference_chunk", 0))
    order = [names.index(n) for n in ref["names"]]
    got_g = [grad_norms[i] for i in order]
    got_c = [change[i] for i in order]
    if ctx.stand_in:
        # the control: the reference in that precision in the program's place
        low = train_steps(cfg, params, [(u8[i * batch:(i + 1) * batch],
                                         labels[i * batch:(i + 1) * batch])
                                        for i in range(COMPARED_STEPS)],
                          tr["lr"], tr["momentum"], norm["mean"], norm["std"],
                          dev, mode=ctx.stand_in,
                          chunk=tr.get("reference_chunk", 0))
        losses, got_g, got_c = (low["losses"], low["grad_norms"],
                                low["change_norms"])
    floor = STILL_LEAF * float(np.median(ref["grad_norms"]))
    moving = [g >= floor for g in ref["grad_norms"]]
    compared = {
        "loss_gap": (loss_gap(losses, ref["losses"]), ctx.limits["loss_gap"]),
        "grad_norm_gap": (norm_gap(got_g, ref["grad_norms"]),
                          ctx.limits["grad_norm_gap"]),
        "change_norm_gap": (norm_gap(got_c, ref["change_norms"], moving),
                            ctx.limits["change_norm_gap"])}
    ok = all(within(v, lim) for v, lim in compared.values())
    if record is not None:
        record["lane"] = {"images": traced * batch, "steps": traced,
                          "batch": batch // world, "image": list(shape),
                          "train": True, "out_bytes": 2}
        if mesh is not None:
            record["lane"]["nccl_s"] = [r["nccl_s"] for r in ranks]
    if mesh is not None:
        import torch.distributed as dist
        dist.barrier()
    return {"e2e": {"train_images_per_s": steps * batch / elapsed},
            "record": record, "correct": ok and np.isfinite(last_loss),
            "compared": compared, "attempted": steps, "failed": 0,
            "memory_peak_bytes": peak,
            "info": {"window_s": elapsed, "steps": steps,
                     "losses": losses, "ref_losses": ref["losses"],
                     "last_loss": last_loss,
                     "leaves_left_out": int(len(moving) - sum(moving))}}


def _any_rank(flag: bool, dev) -> bool:
    """True on every rank when it is True on any."""
    import torch.distributed as dist
    t = torch.tensor([int(flag)], device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def _nccl_s(record) -> float:
    """Device seconds of the traced stretch's NCCL kernels."""
    return sum(d for n, _, _, d in record["ops"] if "nccl" in n.lower())


def faults(ctx):
    """Readings of planted faults that a sound comparison must reject,
    against the float32 reference's three steps: ``half_batch`` (each
    step's loss and gradient taken over the first half of its batch) and,
    on several cards, ``exchange_left_out`` (over rank 0's block alone). A
    state left unchanged reads 1 on ``change_norm_gap`` by the measure
    itself. (The control runs through ``run_cell``'s ``stand_in``.)"""
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    s, batch = cfg["image_size"], tr["batch"]
    shape = (s, s, cfg["in_channels"])
    params = weights.make(cfg, ctx.seed, dev)
    n = COMPARED_STEPS * batch
    images = gen.image_pool(tr["epoch_images"], shape, ctx.seed, dev)[:n]
    labels = gen.labels(tr["epoch_images"], cfg["num_classes"], ctx.seed)[:n]
    norm = tr["normalize"]

    def steps(mode, rows):
        return train_steps(cfg, params, [(images[i * batch:i * batch + rows],
                                          labels[i * batch:i * batch + rows])
                                         for i in range(COMPARED_STEPS)],
                           tr["lr"], tr["momentum"], norm["mean"], norm["std"],
                           dev, mode=mode, chunk=tr.get("reference_chunk", 0))
    want = steps("fp32", batch)
    floor = STILL_LEAF * float(np.median(want["grad_norms"]))
    moving = [g >= floor for g in want["grad_norms"]]
    out = {}
    planted = [("half_batch", steps("fp32", batch // 2))]
    if ctx.cell.chips > 1:
        # the gradient exchange left out: rank 0 steps on its own block
        planted.append(("exchange_left_out",
                        steps("fp32", batch // ctx.cell.chips)))
    for name, got in planted:
        out[name] = {
            "loss_gap": loss_gap(got["losses"], want["losses"]),
            "grad_norm_gap": norm_gap(got["grad_norms"], want["grad_norms"]),
            "change_norm_gap": norm_gap(got["change_norms"],
                                        want["change_norms"], moving)}
    return out
