#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py                      # as the chip check runs it
    python3 chip_smoke.py --profile <dir>      # plus profiled warm passes

Two paths, each through the entry points a user calls:

- serving, the README's transfer-learning quickstart: an
  ``ImageFeaturizer`` with a ResNet-50 (random weights from a seed) scores
  a frame of 256x256x3 uint8 images, resized to 224x224 and normalized on
  the card by the hand-written kernel K2
  (``mmlspark_tpu_torch/kernels/csrc/crop_resize_normalize.cu``);
- training, the JAX package's headline train lane: Frame ->
  ``DeviceEpochCache`` -> ``DistributedTrainer`` steps of ResNet-20 CIFAR
  (bf16 compute, batch 256, sgd 0.1 with momentum 0.9), with the uint8
  batch normalized inside the loss by the hand-written kernel K1
  (``mmlspark_tpu_torch/kernels/csrc/fused_normalize.cu``); then
  ``DeepClassifier`` fits an MLP on a tabular frame and
  ``ComputeModelStatistics`` scores it on its device path.

The script:

1. ``device``: names the card (``nvidia-smi`` name and power limit);
2. ``build``: builds every kernel from the sources in the checkout (nvcc,
   one process per source, all at once) and times it;
3. ``kernel_check``: holds each kernel against its plain PyTorch version on
   the same card tensors at the shapes its path gives it, and times the
   kernel, the plain version, one PyTorch library call as a yardstick
   where one computes the same function (each as device time, replayed
   from a CUDA graph; the kernel also as back-to-back eager calls), and
   the least time the card could take (its bound);
4. ``featurize``: zeroes the launch counts, runs the featurizer, reads the
   counts (K2 once per batch, K1 never), and checks the features against
   the same backbone fed by the plain preprocess; then a logits pass and a
   float32 pass with TF32 off;
5. ``train``: zeroes the counts, runs 3 warm-up steps, one untimed window
   of 40 steps under CUDA's sync-debug mode (it must sync the host only at
   the metrics-ring reads and the final loss fetch), 5 timed windows of 40
   steps with the debug mode off (each making just those counted syncs;
   the median window sets train images/s), and one eval step, reads the
   counts (K1 once per step, K2 never), then holds the loss of 60 bf16
   steps and of 20 fp32 steps (TF32 off) against the same trainer fed by
   K1's plain version;
6. ``deep``: fits ``DeepClassifier`` on 65,536 rows of 128 features,
   scores them, and checks that ``ComputeModelStatistics``'s device path
   gives the host path's metrics with one counted sync;
7. prints the kernel table line, the card's name and power limit, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the exit code is nonzero and no result line is
printed. Without CUDA, or outside a checkout of the repository, it fails
before printing anything.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

# ImageNet normalization in uint8 units, as the torchvision ResNets take it
IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)
N_IMAGES, BATCH, SRC, DST = 512, 128, 256, 224
# the JAX package's train lane (bench.py): CIFAR channel statistics in
# uint8 units, 4096 rows of 32x32x3, batch 256, 3 warm-up steps, windows
# of 40 timed steps, 60 steps of loss parity
CIFAR_MEAN = (125.3, 123.0, 113.9)
CIFAR_STD = (63.0, 62.1, 66.7)
TRAIN_ROWS, TRAIN_BATCH, TRAIN_SHAPE = 4096, 256, (32, 32, 3)
TRAIN_WARMUP, TRAIN_STEPS, PARITY_STEPS, PARITY_F32_STEPS = 3, 40, 60, 20
TRAIN_WINDOWS = 5
DEEP_ROWS, DEEP_FEATURES = 65536, 128
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s
# outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
# fp32 operations per output element of the crop-resize-normalize kernel:
# two row lerps (3 each), one column lerp (3), rint, clamp (2), subtract,
# multiply
K2_OPS_PER_ELEMENT = 14
# of the normalize kernel: subtract, multiply
K1_OPS_PER_ELEMENT = 2


def _line(**obj) -> None:
    print(json.dumps(obj), flush=True)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _median_ms(torch, fn, iters: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back
    calls, from CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def _graph_ms(torch, fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one call: ``iters`` calls captured once in a CUDA
    graph, the graph replayed between CUDA events, the median over
    ``reps`` replays of the mean per call. A replay launches without the
    host, whose per-call overhead (Python, ctypes, the allocator) paces
    back-to-back eager calls of a microsecond kernel (``_median_ms``)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):        # warm up off the capture stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _bound(nbytes: int, ops: int):
    """(bound ms, what bounds it) from the bytes moved and the fp32
    operations done, at the card's published peaks."""
    bytes_ms, ops_ms = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_FP32_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms \
        else "operations"


def phase_kernel_check_k1(torch, tpre, kernel, card):
    """K1 against its plain version at its three shapes (bit-equal
    required); times and bound at each. Returns the train shape's row."""
    shapes = [("train_bf16", (TRAIN_BATCH, math.prod(TRAIN_SHAPE)),
               torch.bfloat16, CIFAR_MEAN, CIFAR_STD),
              ("train_f32", (TRAIN_BATCH, math.prod(TRAIN_SHAPE)),
               torch.float32, CIFAR_MEAN, CIFAR_STD),
              ("train_large_bf16", (128, 224 * 224 * 3), torch.bfloat16,
               (127.5,) * 3, (127.5,) * 3)]
    rows, main = [], None
    for name, shape, dt, mean, std in shapes:
        u8 = torch.from_numpy(np.random.default_rng(3).integers(
            0, 256, shape, dtype=np.uint8)).to(card)
        consts = (torch.tensor(mean, dtype=torch.float32, device=card),
                  torch.from_numpy(tpre._inv_std(std)).to(card))
        got = tpre.fused_normalize(u8, *consts, dt)
        want = tpre._fused_normalize_plain(u8, *consts, dt)
        torch.cuda.synchronize()
        max_err = (got.float() - want.float()).abs().max().item()
        _check(max_err == 0.0 and got.dtype == want.dtype,
               f"K1 {name}: max err {max_err} against its plain version "
               "(bit-equal required)")
        kernel_ms = _graph_ms(
            torch, lambda: tpre.fused_normalize(u8, *consts, dt))
        plain_ms = _graph_ms(
            torch, lambda: tpre._fused_normalize_plain(u8, *consts, dt))
        eager_ms = _median_ms(
            torch, lambda: tpre.fused_normalize(u8, *consts, dt))
        out_size = torch.empty((), dtype=dt).element_size()
        nbytes = u8.numel() * (1 + out_size) + sum(
            t.numel() * t.element_size() for t in consts)
        bound_ms, bound_by = _bound(nbytes, K1_OPS_PER_ELEMENT * u8.numel())
        row = dict(shape=list(shape), out_dtype=str(dt).replace("torch.", ""),
                   max_abs_err=max_err, ms=kernel_ms, plain_ms=plain_ms,
                   eager_ms=eager_ms, bound_ms=bound_ms, bound_by=bound_by,
                   bytes=nbytes, bound_share=bound_ms / kernel_ms)
        rows.append(dict(variant=name, **row))
        if main is None:
            main = row
    _line(phase="kernel_check", kernel=kernel.name,
          launches_while_checking=kernel.launches, variants=rows,
          library="none: no single PyTorch call computes a per-channel "
                  "uint8 normalize with a bf16 or f32 store")
    return main


def phase_kernel_check(torch, tpre, kernel, card):
    """K2 against its plain version; times and bound at the main shape."""
    raw = np.random.default_rng(1).integers(
        0, 256, (BATCH, SRC, SRC, 3), dtype=np.uint8)
    u8 = torch.from_numpy(raw).to(card)
    variants = [
        ("resize", None, (DST, DST), torch.float32),
        ("resize_bf16", None, (DST, DST), torch.bfloat16),
        ("crop_resize", (240, 240), (DST, DST), torch.float32),
        ("crop_only", (DST, DST), None, torch.float32),
    ]
    rows, main = [], None
    for name, crop, resize, dt in variants:
        plan = tpre.CropResizePlan((SRC, SRC, 3), resize=resize, crop=crop,
                                   mean=IMAGENET_MEAN, std=IMAGENET_STD)
        got = tpre.crop_resize_normalize(u8, plan, dt)
        want = tpre._crop_resize_normalize_plain(u8, plan, dt)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        std = torch.tensor(IMAGENET_STD, device=card)
        quanta = (diff * std).max().item()
        share = (diff > 0).float().mean().item()
        max_err = diff.max().item()
        if crop is not None and resize is None:
            tol = 2e-5                   # a crop alone resamples nothing
        else:
            tol = 1.01 / min(IMAGENET_STD)
            if dt == torch.bfloat16:     # plus one bf16 step
                tol += 2 ** -7 * want.float().abs().max().item()
        _check(max_err <= tol and share <= 0.01,
               f"K2 {name}: max err {max_err} (tol {tol}), "
               f"share differing {share}")
        row = dict(variant=name, out_dtype=str(dt).replace("torch.", ""),
                   max_abs_err=max_err, max_quanta=quanta,
                   share_differing=share, tolerance=tol)
        if name == "resize":
            xf = u8.permute(0, 3, 1, 2).float()   # NCHW view, channels-last
            f = torch.nn.functional.interpolate
            kernel_ms = _graph_ms(
                torch, lambda: tpre.crop_resize_normalize(u8, plan, dt))
            plain_ms = _graph_ms(
                torch, lambda: tpre._crop_resize_normalize_plain(u8, plan, dt))
            library_ms = _graph_ms(
                torch, lambda: f(xf, size=(DST, DST), mode="bilinear",
                                 align_corners=False, antialias=False))
            eager_ms = _median_ms(
                torch, lambda: tpre.crop_resize_normalize(u8, plan, dt))
            nbytes = plan.bytes_moved(BATCH, dt) + sum(
                t.numel() * t.element_size() for t in plan.on(card))
            ops = K2_OPS_PER_ELEMENT * BATCH * DST * DST * 3
            bound_ms, bound_by = _bound(nbytes, ops)
            main = dict(ms=kernel_ms, plain_ms=plain_ms,
                        library_ms=library_ms, max_abs_err=max_err,
                        bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                        ops=ops)
            row.update(kernel_ms=kernel_ms, plain_ms=plain_ms,
                       library_ms=library_ms, eager_ms=eager_ms,
                       bound_us=main["bound_ms"] * 1e3,
                       bound_share=main["bound_ms"] / kernel_ms)
        rows.append(row)
    _line(phase="kernel_check", kernel=kernel.name, shape=[BATCH, SRC, SRC, 3],
          launches_while_checking=kernel.launches, variants=rows)
    return main


def phase_featurize(torch, kernels, card, profile_dir=None):
    """The main path through the public entry points, and its checks.
    With ``profile_dir``, one more warm pass runs under ``torch.profiler``
    and its per-kernel device times are written there."""
    from mmlspark_tpu_torch.core.frame import Frame
    from mmlspark_tpu_torch.core.schema import ColumnSchema, DType, ImageValue
    from mmlspark_tpu_torch.image.featurizer import ImageFeaturizer
    from mmlspark_tpu_torch.models.zoo import build_model, init_state
    from mmlspark_tpu_torch.ops.preprocess import (
        CropResizePlan, _crop_resize_normalize_plain,
    )

    raw = np.random.default_rng(2).integers(
        0, 256, size=(N_IMAGES, SRC, SRC, 3), dtype=np.uint8)
    imgs = np.empty(N_IMAGES, dtype=object)
    for i in range(N_IMAGES):
        imgs[i] = ImageValue(path=f"mem://smoke/{i}", data=raw[i])
    frame = Frame.from_dict({"row": np.arange(N_IMAGES)}, num_partitions=4)
    frame = frame.with_column_values(ColumnSchema("image", DType.IMAGE), imgs)
    batches = math.ceil(N_IMAGES / BATCH)

    def featurizer(cut, compute, **arch):
        fz = ImageFeaturizer(inputCol="image", outputCol="features",
                             cutOutputLayers=cut, miniBatchSize=BATCH,
                             computeDtype=compute)
        return fz.set_model("resnet50", num_classes=1000, seed=0, **arch)

    def reference(compute, **arch):
        """The same backbone and weights, fed by the plain preprocess on
        the card: (pool features, logits) as float32 numpy."""
        spec = build_model("resnet50", num_classes=1000, **arch)
        module = spec["module"]
        module.load_state_dict({k: torch.from_numpy(v) for k, v in
                                init_state(module, seed=0).items()})
        module = module.to(card).eval()
        if compute == "bfloat16":
            module = module.to(torch.bfloat16)
        module = module.to(memory_format=torch.channels_last)
        plan = CropResizePlan((SRC, SRC, 3),
                              resize=tuple(spec["input_shape"][:2]))
        pools, logits = [], []
        with torch.inference_mode():
            for i in range(0, N_IMAGES, BATCH):
                x = _crop_resize_normalize_plain(
                    torch.from_numpy(raw[i:i + BATCH]).to(card), plan)
                if compute == "bfloat16":
                    x = x.to(torch.bfloat16)
                lg, inters = module.forward_with_intermediates(x)
                pools.append(inters["pool"].float().cpu().numpy())
                logits.append(lg.float().cpu().numpy())
        return np.concatenate(pools), np.concatenate(logits)

    def rel_err(got, want):
        return float(np.abs(got - want).max() / np.abs(want).max())

    # the main path: counts zeroed just before, read just after
    fz = featurizer(1, "bfloat16")
    kernels.reset_launches()
    t0 = time.perf_counter()
    feats = np.asarray(fz.transform(frame).column("features"))
    first_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.KERNELS}
    _check(feats.shape == (N_IMAGES, 2048), f"features shape {feats.shape}")
    _check(bool(np.isfinite(feats).all()), "features not all finite")
    want = {k.name: 0 for k in kernels.KERNELS}
    want[kernels.CROP_RESIZE_NORMALIZE.name] = batches
    _check(launches == want, f"kernels launched {launches} times on the "
                             f"featurize path, want {want} (K2 once per "
                             "batch, no other kernel)")

    # timed passes: unroll memo and resident upload are warm, so each is
    # the card's scoring work plus one fetch of the features
    kernels.reset_launches()
    pass_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = np.asarray(fz.transform(frame).column("features"))
        pass_s.append(time.perf_counter() - t0)
    _check(np.array_equal(again, feats), "a repeat pass changed the features")
    _check(kernels.CROP_RESIZE_NORMALIZE.launches == 3 * batches,
           "repeat passes did not launch the kernel once per batch")
    if profile_dir:
        _profile_pass(torch, lambda: fz.transform(frame), profile_dir,
                      "featurize")
    ref_pool, ref_logits = reference("bfloat16")
    # bf16 tolerance: the kernel and the plain preprocess agree to a uint8
    # quantum (in practice bit for bit), and the backbone is the same bf16
    # program on the same card; 2% of the features' scale leaves room for
    # a cuDNN algorithm picked differently between the two runs
    pool_err = rel_err(feats, ref_pool)
    _check(pool_err <= 0.02, f"bf16 features vs plain route: {pool_err}")

    logits = np.asarray(featurizer(0, "bfloat16").transform(frame)
                        .column("features"))
    _check(logits.shape == (N_IMAGES, 1000)
           and bool(np.isfinite(logits).all()), "logits shape/finite")
    logit_err = rel_err(logits, ref_logits)
    _check(logit_err <= 0.02, f"bf16 logits vs plain route: {logit_err}")

    # float32 parity: TF32 off for cuDNN convs and for matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = np.asarray(featurizer(1, "float32", dtype="float32")
                     .transform(frame).column("features"))
    ref32, _ = reference("float32", dtype="float32")
    f32_err = float(np.abs(f32 - ref32).max())
    _check(f32_err <= 1e-3, f"fp32 features vs plain route: {f32_err}")

    best = min(pass_s)
    _line(phase="featurize", card=_smi(), model="resnet50", images=N_IMAGES,
          batch=BATCH, src=[SRC, SRC, 3], dst=[DST, DST], batches=batches,
          launches_main_path=launches, first_pass_s=first_s,
          timed_pass_s=pass_s, images_per_s=N_IMAGES / statistics.median(
              pass_s), images_per_s_best=N_IMAGES / best,
          bf16_pool_rel_err=pool_err, bf16_logits_rel_err=logit_err,
          fp32_tf32_off_max_abs_err=f32_err, tf32="off for the fp32 check")
    return launches


def phase_train(torch, kernels, card, profile_dir=None):
    """The train lane through the public entry points (the counts zeroed
    just before, read just after), its sync check, and the loss parity of
    the K1 route against K1's plain version."""
    import torch.nn.functional as F
    from mmlspark_tpu_torch.core.frame import Frame
    from mmlspark_tpu_torch.models.zoo import build_model, init_state
    from mmlspark_tpu_torch.observability import syncs
    from mmlspark_tpu_torch.observability.metrics import (
        H100_SXM_BF16_DENSE_FLOPS,
    )
    from mmlspark_tpu_torch.ops.preprocess import (
        _fused_normalize_plain, _inv_std, make_preprocess_fn,
    )
    from mmlspark_tpu_torch.parallel.optim import sgd
    from mmlspark_tpu_torch.parallel.trainer import (
        DeviceEpochCache, DistributedTrainer,
    )

    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (TRAIN_ROWS, math.prod(TRAIN_SHAPE)),
                          dtype=np.uint8)
    labels = rng.integers(0, 10, TRAIN_ROWS).astype(np.int32)
    frame = Frame.from_dict({"image": images, "label": labels},
                            num_partitions=8)
    epoch = {"image": frame.column("image").astype(np.uint8),
             "label": frame.column("label").astype(np.int32)}

    def lane(pre, dtype="bfloat16"):
        """ResNet-20 CIFAR at full width (random weights from seed 0),
        sgd(0.1, momentum 0.9), and an endless unshuffled epoch."""
        module = build_model("resnet20_cifar", num_classes=10,
                             dtype=dtype)["module"]
        module.load_state_dict({k: torch.from_numpy(v) for k, v in
                                init_state(module, seed=0).items()})

        def loss_fn(module, batch, gen):
            logits = module(pre(batch["image"])).float()
            return F.cross_entropy(logits, batch["label"].long())
        trainer = DistributedTrainer(loss_fn, sgd(0.1, momentum=0.9))
        state = trainer.init(lambda: module)
        cache = DeviceEpochCache(epoch, TRAIN_BATCH)

        def batches():
            while True:
                yield from cache.batches(0)
        return trainer, state, batches()

    def plain_pre(out_dtype):
        mean = torch.tensor(CIFAR_MEAN, dtype=torch.float32, device=card)
        istd = torch.from_numpy(_inv_std(CIFAR_STD)).to(card)
        return lambda u8: _fused_normalize_plain(
            u8, mean, istd, out_dtype).reshape((u8.shape[0],) + TRAIN_SHAPE)

    # the main path: counts zeroed just before, read just after
    trainer, state, it = lane(make_preprocess_fn(TRAIN_SHAPE, CIFAR_MEAN,
                                                 CIFAR_STD))
    kernels.reset_launches()
    t0 = time.perf_counter()
    state, m = trainer.train_step(state, next(it), 1)
    syncs.device_get(m["loss"], "smoke.first_step")
    first_s = time.perf_counter() - t0
    for _ in range(TRAIN_WARMUP - 1):
        state, m = trainer.train_step(state, next(it), 1)
    expected_syncs = TRAIN_STEPS // trainer.flush_steps() + 1

    def window():
        """TRAIN_STEPS steps from a fresh ring read, ending in one fetch of
        the last loss; returns (loss, counted syncs)."""
        nonlocal state
        trainer.flush_metrics()
        sync0 = syncs.total()
        for _ in range(TRAIN_STEPS):
            state, m = trainer.train_step(state, next(it), 1)
        loss = float(syncs.device_get(m["loss"], "smoke.final_fetch"))
        return loss, syncs.total() - sync0

    # the sync check, untimed: any sync outside observability/syncs.py
    # raises a CUDA sync-debug warning
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, check_syncs = window()
    torch.cuda.set_sync_debug_mode(0)
    _check(check_syncs == expected_syncs,
           f"{check_syncs} counted syncs in {TRAIN_STEPS} steps, want "
           f"{expected_syncs} (the ring reads and the final fetch)")
    syncing = [w for w in caught if "synchroniz" in str(w.message)]
    hidden = [f"{w.filename}:{w.lineno}" for w in syncing
              if not w.filename.endswith("syncs.py")]
    _check(not hidden, f"uncounted host syncs in the train steps: {hidden}")

    # the timed windows, debug mode off; beside each window's wall time the
    # process's CPU time and the host's load, to tell a host that computes
    # from one that waits
    windows = []
    for _ in range(TRAIN_WINDOWS):
        cpu0, t0 = time.process_time(), time.perf_counter()
        final_loss, timed_syncs = window()
        wall = time.perf_counter() - t0
        _check(timed_syncs == expected_syncs,
               f"{timed_syncs} counted syncs in a timed window, want "
               f"{expected_syncs}")
        windows.append(dict(wall_s=wall, cpu_s=time.process_time() - cpu0,
                            images_per_s=TRAIN_BATCH * TRAIN_STEPS / wall,
                            loadavg_1m=os.getloadavg()[0]))
    eval_loss = float(syncs.device_get(
        trainer.eval_step(state, next(it), 1), "smoke.eval"))
    launches = {k.name: k.launches for k in kernels.KERNELS}

    steps = TRAIN_WARMUP + TRAIN_STEPS * (1 + TRAIN_WINDOWS)
    want = {k.name: 0 for k in kernels.KERNELS}
    want[kernels.FUSED_NORMALIZE.name] = steps + 1      # + the eval step
    _check(launches == want, f"kernels launched {launches} times on the "
                             f"train path, want {want} (K1 once per train "
                             "and eval step, no other kernel)")
    _check(math.isfinite(final_loss) and math.isfinite(eval_loss)
           and int(syncs.device_get(state["step"], "smoke.step")) == steps,
           "train loss not finite or step counter off")
    rates = [w["images_per_s"] for w in windows]
    images_per_s = statistics.median(rates)
    step_s = TRAIN_BATCH / images_per_s
    flops = trainer.flops_per_step
    tflops = flops / step_s / 1e12
    if profile_dir:
        def five_steps():
            nonlocal state
            for _ in range(5):
                state, _ = trainer.train_step(state, next(it), 1)
            torch.cuda.synchronize()
        _profile_pass(torch, five_steps, profile_dir, "train")

    # loss parity of the K1 route against K1's plain version, with cuDNN
    # deterministic so the two runs differ only in the preprocess
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    def losses(pre, n, dtype="bfloat16"):
        tr, st, batches = lane(pre, dtype)
        out = []
        for _ in range(n):
            st, mm = tr.train_step(st, next(batches), 1)
            out.append(mm["loss"])
        return syncs.device_get(torch.stack(out), "smoke.parity")

    k1 = losses(make_preprocess_fn(TRAIN_SHAPE, CIFAR_MEAN, CIFAR_STD),
                PARITY_STEPS)
    plain = losses(plain_pre(torch.bfloat16), PARITY_STEPS)
    bf16_rel = float(abs(k1[-1] - plain[-1]) / abs(plain[-1]))
    bf16_step = float(np.max(np.abs(k1 - plain) / np.abs(plain)))
    _check(bf16_rel <= 1e-3, f"bf16 {PARITY_STEPS}-step final loss, K1 "
                             f"route vs plain: rel diff {bf16_rel}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    k1_32 = losses(make_preprocess_fn(TRAIN_SHAPE, CIFAR_MEAN, CIFAR_STD,
                                      out_dtype=torch.float32),
                   PARITY_F32_STEPS, "float32")
    plain_32 = losses(plain_pre(torch.float32), PARITY_F32_STEPS, "float32")
    f32_rel = float(abs(k1_32[-1] - plain_32[-1]) / abs(plain_32[-1]))
    f32_step = float(np.max(np.abs(k1_32 - plain_32) / np.abs(plain_32)))
    _check(f32_rel <= 1e-5, f"fp32 {PARITY_F32_STEPS}-step final loss, K1 "
                            f"route vs plain: rel diff {f32_rel}")
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.allow_tf32 = True
    _check(bool(np.isfinite(k1).all() and np.isfinite(k1_32).all()),
           "parity losses not finite")

    _line(phase="train", card=_smi(), model="resnet20_cifar",
          rows=TRAIN_ROWS, batch=TRAIN_BATCH, compute="bfloat16",
          optimizer="sgd(0.1, momentum=0.9)", warmup_steps=TRAIN_WARMUP,
          steps_per_window=TRAIN_STEPS, windows=windows,
          first_step_s=first_s, step_ms=step_s * 1e3,
          train_images_per_s=images_per_s,
          train_images_per_s_min=min(rates),
          train_images_per_s_max=max(rates),
          spread_max_over_min=max(rates) / min(rates),
          flops_per_step=flops, achieved_tflops=tflops,
          mfu_vs_bf16_dense_peak=tflops * 1e12 / H100_SXM_BF16_DENSE_FLOPS,
          launches_main_path=launches, syncs_per_window=timed_syncs,
          expected_syncs=expected_syncs,
          sync_warnings_in_counted_syncs=len(syncing),
          final_loss=final_loss, eval_loss=eval_loss,
          parity_bf16=dict(steps=PARITY_STEPS, final_rel_diff=bf16_rel,
                           max_step_rel_diff=bf16_step, tolerance=1e-3,
                           first_loss=float(k1[0]), last_loss=float(k1[-1])),
          parity_fp32_tf32_off=dict(steps=PARITY_F32_STEPS,
                                    final_rel_diff=f32_rel,
                                    max_step_rel_diff=f32_step,
                                    tolerance=1e-5))
    return launches


def phase_deep(torch, card):
    """DeepClassifier on a tabular frame, scored, then evaluated by
    ComputeModelStatistics on its device path against its host path."""
    from mmlspark_tpu_torch.core.frame import Frame
    from mmlspark_tpu_torch.evaluate.compute_model_statistics import (
        ComputeModelStatistics,
    )
    from mmlspark_tpu_torch.observability import syncs
    from mmlspark_tpu_torch.train.deep import DeepClassifier
    from mmlspark_tpu_torch.utils import config

    rng = np.random.default_rng(5)
    X = rng.normal(size=(DEEP_ROWS, DEEP_FEATURES)).astype(np.float32)
    y = (X @ rng.normal(size=DEEP_FEATURES) > 0).astype(np.int64)
    frame = Frame.from_dict({"features": X, "label": y}, num_partitions=4)
    learner = DeepClassifier(architecture="mlp_tabular", batchSize=256,
                             epochs=2, deviceCache="on")
    learner.set_params(featuresCol="features", labelCol="label")
    t0 = time.perf_counter()
    model = learner.fit(frame)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scored = model.transform(frame)
    score_s = time.perf_counter() - t0
    pred = scored.column("prediction")
    acc = float((pred.astype(np.int64) == y).mean())
    _check(pred.shape == (DEEP_ROWS,) and acc > 0.9,
           f"DeepClassifier accuracy {acc} on separable data")

    def evaluate(device_rows):
        config.set("evaluate.device_rows", device_rows)
        try:
            ev = ComputeModelStatistics(labelCol="label",
                                        scoredLabelsCol="prediction",
                                        scoresCol="probability")
            row = ev.transform(scored).head(1)[0]
        finally:
            config.unset("evaluate.device_rows")
        return {k: float(v) for k, v in row.items()}, ev.confusion_matrix

    before = syncs.counts().get("evaluate.finalize", 0)
    t0 = time.perf_counter()
    dev, cm_dev = evaluate(0)
    eval_s = time.perf_counter() - t0
    finalize = syncs.counts().get("evaluate.finalize", 0) - before
    host, cm_host = evaluate(10 ** 12)
    _check(finalize == 1, f"evaluate.finalize counted {finalize} times")
    _check(np.array_equal(cm_dev, cm_host) and cm_dev.sum() == DEEP_ROWS,
           f"confusion matrices differ: {cm_dev} vs {cm_host}")
    for name in ("accuracy", "precision", "recall"):
        _check(dev[name] == host[name],
               f"{name}: device {dev[name]} vs host {host[name]}")
    # AUC and areaUnderPR: float32 sums on the card against float64 numpy
    for name in ("AUC", "AUC_PR"):
        _check(abs(dev[name] - host[name]) <= 1e-5,
               f"{name}: device {dev[name]} vs host {host[name]}")
    _line(phase="deep", card=_smi(), rows=DEEP_ROWS, features=DEEP_FEATURES,
          architecture="mlp_tabular", batch=256, epochs=2,
          fit_s=fit_s, score_s=score_s, eval_device_s=eval_s,
          accuracy=acc, device_metrics=dev, host_metrics=host,
          confusion_matrix=cm_dev.tolist(), evaluate_finalize_syncs=finalize)


def _profile_pass(torch, run, out_dir, name) -> None:
    """One warm ``run()`` under torch.profiler: the device time by kernel
    (top 25) and the device's busy share of the run, as a JSON line; the
    full table and a Chrome trace go to ``out_dir`` as ``<name>_*``."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_s = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:25]
    with open(os.path.join(out_dir, f"{name}_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(
            sort_by="self_cuda_time_total", row_limit=60))
    prof.export_chrome_trace(os.path.join(out_dir, f"{name}_trace.json"))
    _line(phase="profile", of=name, wall_s=wall_s,
          device_busy_s=busy_us / 1e6,
          device_busy_share=busy_us / 1e6 / wall_s,
          top=[{"name": e.key[:80], "device_ms": e.self_device_time_total
                / 1e3, "calls": e.count} for e in top])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA card", file=sys.stderr)
        return 2
    from mmlspark_tpu_torch import kernels
    from mmlspark_tpu_torch.ops import preprocess as tpre

    smi = _smi()
    _line(phase="device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, cudnn=torch.backends.cudnn.version())

    t0 = time.perf_counter()
    status = kernels.build_all()
    _line(phase="build", seconds=time.perf_counter() - t0, status=status,
          cache_hit=all(v == "hit" for v in status.values()),
          ptxas={k.name: [ln.strip() for ln in k.build_log.splitlines()
                          if "registers" in ln or "spill" in ln]
                 for k in kernels.KERNELS})

    card = torch.device("cuda", 0)
    k1 = phase_kernel_check_k1(torch, tpre, kernels.FUSED_NORMALIZE, card)
    k2 = phase_kernel_check(torch, tpre, kernels.CROP_RESIZE_NORMALIZE, card)
    profile_dir = None
    if "--profile" in sys.argv[1:]:
        profile_dir = sys.argv[sys.argv.index("--profile") + 1]
    featurize = phase_featurize(torch, kernels, card, profile_dir)
    train = phase_train(torch, kernels, card, profile_dir)
    phase_deep(torch, card)

    k1k, k2k = kernels.FUSED_NORMALIZE, kernels.CROP_RESIZE_NORMALIZE
    _line(kernels=[{
        "name": k1k.name, "route": "cuda",
        "source": "mmlspark_tpu_torch/kernels/csrc/fused_normalize.cu",
        "replaces": "mmlspark_tpu/ops/pallas_preprocess.py:43",
        "launches": train[k1k.name], "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes this function"}, {
        "name": k2k.name, "route": "cuda",
        "source": "mmlspark_tpu_torch/kernels/csrc/crop_resize_normalize.cu",
        "replaces": "mmlspark_tpu/ops/pallas_preprocess.py:147",
        "launches": featurize[k2k.name], "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
        "library_ms": k2["library_ms"]}])
    print(_smi(), flush=True)
    _line(ok=True, device={"platform": "gpu",
                           "kind": torch.cuda.get_device_name(0),
                           "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
