"""Batch featurization: a closed loop of ``ImageFeaturizer.transform`` over
fresh Frames of uint8 images, drawn in turn from a seeded pool.

Traffic keys: ``image`` [H, W, C] of the uint8 source images;
``pool_images``; ``frame_images`` (rows a Frame holds); ``mini_batch``;
``cut_output_layers`` (1: the pool layer, 0: the logits); ``partitions``.
End-to-end: ``images_per_s``, every image whose features reached the host
in the window over the window. ``correct``: every answer of the window
against the float32 reference of its image (``row_rel_err``)."""
import itertools

import numpy as np
import torch

from cardbench import gen, weights
from cardbench.compare import row_rel_err
from cardbench.harness import free_device, within
from cardbench.lanes import now, peak_bytes, sync, trace_start
from cardbench.reference.drive import pool_outputs


def _frames(ctx, pool):
    """Endless (pool indices, Frame) of ``frame_images`` rows each."""
    from mmlspark_tpu_torch.core.frame import Frame
    from mmlspark_tpu_torch.core.schema import ColumnSchema, DType, ImageValue
    tr = ctx.traffic
    per = tr["frame_images"]
    stream = gen.pool_stream(len(pool), ctx.seed)
    while True:
        idx = np.fromiter(itertools.islice(stream, per), np.int64, per)
        imgs = np.empty(per, dtype=object)
        for i, j in enumerate(idx):
            imgs[i] = ImageValue(path=f"mem://cardbench/{j}", data=pool[j])
        frame = Frame.from_dict({"row": np.arange(per)},
                                num_partitions=tr["partitions"])
        yield idx, frame.with_column_values(
            ColumnSchema("image", DType.IMAGE), imgs)


def featurizer(cfg, tr, params):
    from mmlspark_tpu_torch.image.featurizer import ImageFeaturizer
    fz = ImageFeaturizer(inputCol="image", outputCol="features",
                         cutOutputLayers=tr["cut_output_layers"],
                         miniBatchSize=tr["mini_batch"],
                         computeDtype=cfg["compute_dtype"])
    return fz.set_model(cfg["architecture"], params=params, **cfg["arch_args"])


def served_dtype(cfg):
    return getattr(torch, cfg["compute_dtype"])


def run(ctx):
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    params = weights.make(cfg, ctx.seed, dev, round_to=served_dtype(cfg))
    ctx.mark("weights")
    pool = gen.image_pool(tr["pool_images"], tr["image"], ctx.seed, dev)
    ctx.mark("inputs")
    fz = featurizer(cfg, tr, params)
    frames = _frames(ctx, pool)
    for _ in range(tr["warm_frames"]):
        _, frame = next(frames)
        fz.transform(frame).column("features")
    ctx.tracer.warm()
    sync(dev)
    ctx.mark("warm")

    span = ctx.tracer.span
    answers, images, frame_s = [], 0, []
    t_on = trace_start(ctx)
    tracing, record, traced = False, None, 0
    t0 = ctx.window_opens()
    while True:
        if ctx.trace and not tracing and now() - t0 >= t_on:
            ctx.tracer.start()
            tracing = True
        with span("frame"):
            idx, frame = next(frames)
        with span("transform"):
            out = fz.transform(frame)
        with span("column"):
            feats = np.asarray(out.column("features"))
        answers.append((idx, feats))
        images += len(idx)
        frame_s.append(now())
        traced += len(idx) if tracing else 0
        t = now()
        if t - t0 >= ctx.seconds:
            break
    elapsed = t - t0
    if tracing:
        record = ctx.tracer.stop()
    peak = peak_bytes(dev)
    del fz, frames, frame, out
    free_device()

    layer = "pool" if tr["cut_output_layers"] == 1 else "logits"
    used = np.unique(np.concatenate([a[0] for a in answers]))
    ref = pool_outputs(cfg, params, pool, used, layer, dev)
    answers = stand_in(ctx, answers, params, pool, used, layer)
    err, bad = row_rel_err(answers, ref)
    limit = ctx.limits["row_rel_err"]
    if record is not None:
        record["lane"] = {"images": traced, "batch": tr["mini_batch"],
                          "batches": traced // tr["mini_batch"],
                          "src": tr["image"], "train": False,
                          "out_bytes": served_dtype(cfg).itemsize}
    return {"e2e": {"images_per_s": images / elapsed},
            "record": record, "correct": within(err, limit) and bad == 0,
            "compared": {"row_rel_err": (err, limit)},
            "attempted": images, "failed": bad,
            "memory_peak_bytes": peak,
            "info": {"window_s": elapsed, "images": images,
                     "frames": len(answers),
                     "frame_s": np.diff([t0] + frame_s).round(4).tolist()}}


def stand_in(ctx, answers, params, pool, used, layer):
    """The program's answers, or with ``ctx.stand_in`` (the control) the
    reference's in that precision for the same images in their place."""
    if not ctx.stand_in:
        return answers
    low = pool_outputs(ctx.cfg, params, pool, used, layer, ctx.device,
                       mode=ctx.stand_in)
    return [(idx, np.stack([low[i] for i in idx])) for idx, _ in answers]
