#!/usr/bin/env python3
"""Drive the PyTorch port's main serving path on one CUDA card and check it.

    python3 chip_smoke.py                      # as the chip check runs it
    python3 chip_smoke.py --profile <dir>      # plus a profiled warm pass

The main path is the README's transfer-learning quickstart: an
``ImageFeaturizer`` with a ResNet-50 (random weights from a seed) scores a
frame of 256x256x3 uint8 images; uniform uint8 images cross to the card raw
and are resized to 224x224 and normalized there by the port's hand-written
CUDA kernel (``mmlspark_tpu_torch/kernels/csrc/crop_resize_normalize.cu``)
ahead of the first conv. The script:

1. ``device``: names the card (``nvidia-smi`` name and power limit);
2. ``build``: builds every kernel from the sources in the checkout (nvcc,
   one process per source, all at once) and times it;
3. ``kernel_check``: holds each kernel against its plain PyTorch version on
   the same card tensors at the main path's shape (and crop variants), and
   times the kernel, the plain version, one PyTorch library call as a
   yardstick, and the least time the card could take (its bound);
4. ``featurize``: zeroes the launch counts, runs the featurizer through
   its public entry points, reads the counts, and checks the features
   against the same backbone fed by the plain preprocess on the card; then
   a logits pass and a float32 pass with TF32 off;
5. prints the kernel table line, the card's name and power limit, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the exit code is nonzero and no result line is
printed. Without CUDA, or outside a checkout of the repository, it fails
before printing anything.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

# ImageNet normalization in uint8 units, as the torchvision ResNets take it
IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)
N_IMAGES, BATCH, SRC, DST = 512, 128, 256, 224
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s
# outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
# fp32 operations per output element of the crop-resize-normalize kernel:
# two row lerps (3 each), one column lerp (3), rint, clamp (2), subtract,
# multiply
K2_OPS_PER_ELEMENT = 14


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


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


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
            kernel_ms = _median_ms(
                torch, lambda: tpre.crop_resize_normalize(u8, plan, dt))
            plain_ms = _median_ms(
                torch, lambda: tpre._crop_resize_normalize_plain(u8, plan, dt))
            library_ms = _median_ms(
                torch, lambda: f(xf, size=(DST, DST), mode="bilinear",
                                 align_corners=False, antialias=False))
            nbytes = plan.bytes_moved(BATCH, dt) + sum(
                t.numel() * t.element_size() for t in plan.on(card))
            ops = K2_OPS_PER_ELEMENT * BATCH * DST * DST * 3
            bytes_ms, ops_ms = nbytes / PEAK_BYTES_S * 1e3, \
                ops / PEAK_FP32_S * 1e3
            main = dict(ms=kernel_ms, plain_ms=plain_ms,
                        library_ms=library_ms, max_abs_err=max_err,
                        bound_ms=max(bytes_ms, ops_ms),
                        bound_by="bytes" if bytes_ms >= ops_ms
                        else "operations", bytes=nbytes, ops=ops)
            row.update(kernel_ms=kernel_ms, plain_ms=plain_ms,
                       library_ms=library_ms,
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
    from mmlspark_tpu_torch.models.zoo.resnet import apply_with_intermediates
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
                lg, inters = apply_with_intermediates(module, x)
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
    for name, n in launches.items():
        _check(n == batches, f"kernel {name} launched {n} times on the main "
                             f"path, want {batches} (one per batch)")

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
        _profile_pass(torch, lambda: fz.transform(frame), profile_dir)
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


def _profile_pass(torch, run, out_dir) -> None:
    """One warm featurize pass under torch.profiler: the device time by
    kernel (top 25) and the device's busy share of the pass, as a JSON
    line; the full table and a Chrome trace go to ``out_dir``."""
    import os
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
    with open(os.path.join(out_dir, "featurize_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(
            sort_by="self_cuda_time_total", row_limit=60))
    prof.export_chrome_trace(os.path.join(out_dir, "featurize_trace.json"))
    _line(phase="profile", wall_s=wall_s, device_busy_s=busy_us / 1e6,
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
    k2 = phase_kernel_check(torch, tpre, kernels.CROP_RESIZE_NORMALIZE, card)
    profile_dir = None
    if "--profile" in sys.argv[1:]:
        profile_dir = sys.argv[sys.argv.index("--profile") + 1]
    launches = phase_featurize(torch, kernels, card, profile_dir)

    k = kernels.CROP_RESIZE_NORMALIZE
    _line(kernels=[{
        "name": k.name, "route": "cuda",
        "source": "mmlspark_tpu_torch/kernels/csrc/crop_resize_normalize.cu",
        "replaces": "mmlspark_tpu/ops/pallas_preprocess.py:147",
        "launches": launches[k.name], "max_abs_err": k2["max_abs_err"],
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
