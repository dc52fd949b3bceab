#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py                      # as the chip check runs it
    python3 chip_smoke.py --profile <dir>      # plus profiled warm passes

Three paths, each through the entry points a user calls:

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
  ``ComputeModelStatistics`` scores it on its device path;
- attention models: ``TorchModel`` scores token ids through
  ``transformer_lm`` at the zoo's width (vocab 32000, dim 512, depth 6,
  8 heads, L 2048; bf16, random weights from a seed) for its ``hidden``
  layer, every block's causal attention running the hand-written kernel K3
  on the tensor cores (``mmlspark_tpu_torch/kernels/csrc/
  flash_attention_wgmma.cu``; f32 takes the CUDA-core
  ``flash_attention.cu``); then the MoE LM the same way, and
  ``ImageFeaturizer`` with ViT-B/16 (K2, no K3).

The script:

1. ``device``: names the card (``nvidia-smi`` name and power limit);
2. ``build``: builds every kernel from the sources in the checkout (nvcc,
   one process per source, all at once), times it, prints ptxas's
   registers and spill bytes for every compiled function, and fails if an
   instantiation of any kernel spills;
3. ``kernel_check``: holds each kernel against its plain PyTorch version on
   the same card tensors at the shapes its path gives it (K3 also at the
   JAX bench's ``longctx`` shape and at head dims 16, 128, 256 and 512, each
   variant through the route its dtype and head dim pick, with both K3
   kernels' launches counted across the kernel call and the plain call),
   and times the
   kernel, the plain version, one PyTorch library call as a yardstick
   where one computes the same function (each as device time, replayed
   from a CUDA graph; the kernel also as back-to-back eager calls), and
   the least time the card could take (its bound); K1 and K2 also beside
   their launch floor (an empty kernel on the same grid, from their
   libraries' ``*_empty`` entry points), K1 over the 16 distinct batch
   slices of a resident epoch, and K2 in bf16 (the featurize path's
   output) and f32, through each of its variants (staged, direct-load),
   with ptxas's registers and spills of each kernel's functions;
4. ``featurize``: zeroes the launch counts, runs the featurizer, reads the
   counts (K2's staged variant once per batch, storing bf16; K1 never),
   and checks the features against
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
7. ``lm_score``: zeroes the counts, scores 64 rows of 2048 ids (batch 8),
   reads the counts (K3's tensor-core kernel 6 layers x 8 batches = 48
   times, no other kernel), times 3 warm passes (tokens/s, each pass 48
   launches), and
   holds ``hidden`` against the same module and weights with the
   reference attention (``use_flash="never"``) in bf16 and in fp32 (TF32
   off; the fp32 pass launches K3's CUDA-core kernel instead, and one warm
   fp32 pass is timed); one logits pass checks the default output;
8. ``moe_score``: ``transformer_lm_moe`` over 16 rows (K3's tensor-core
   kernel 6 times a batch), against its reference-attention route;
9. ``featurize_vit``: ViT-B/16 features of 128 uint8 images 256x256x3
   through ``ImageFeaturizer`` (resized to 224 by K2) and through
   ``TorchModel`` center-cropping to 224 on the card (K2), each against
   the plain-preprocess route;
10. prints the kernel table line, the card's name and power limit, and
    last ``{"ok": true, "device": {...}}``.

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
# the zoo's transformer_lm (vocab 32000, dim 512, depth 6, 8 heads, L 2048):
# 64 rows of ids scored at batch 8; the MoE LM over 16 rows
LM_ROWS, LM_BATCH, LM_LEN, LM_VOCAB, LM_DEPTH = 64, 8, 2048, 32000, 6
MOE_ROWS, LM_F32_ROWS = 16, 16
# ViT-B/16 as the JAX bench's vit_preprocess lane feeds it: 256x256 uint8,
# 224 on the card, mean = std = 127.5, batch 32
VIT_IMAGES, VIT_BATCH = 128, 32
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s
# outside the tensor cores, dense bf16 tensor-core FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_BF16_S = 989e12
# K3 against its plain version: fp32 sums in another order (2e-5), and in
# bf16 on the CUDA-core route (D > 128) one bf16 step of the value beyond
# that
K3_F32_TOL = 2e-5
# K3's tensor-core route (bf16, D <= 128) against its plain version, which
# keeps p in fp32: rounding each p_j to bf16 moves it by at most bf16's unit
# roundoff 2^-8 of itself, so an output moves by at most 2^-8 max|v|; plus
# K3_F32_TOL and one bf16 step of the output. The mean |difference| is held
# to 2^-8 of the mean |output|: a CPU emulation of the route's arithmetic
# (tests/test_torch_attention.py, L = 512, D 16/64/128, causal or not)
# reads 0.32-0.38 of that ceiling and at most 0.50 of the bound
TC_P_ROUNDING, TC_MEAN_CEILING = 2.0 ** -8, 2.0 ** -8
# the LM's hidden (unit-variance final-norm output, |x| up to ~5), K3 route
# against the reference-attention route. bf16: the reference rounds the
# normalized p to bf16 before p.v, K3's tensor-core route the p of its
# running max, so attention outputs differ by about one bf16 step, which
# the bf16 residual sums of 6 blocks carry on (one step at
# magnitude 4 is 0.016): max 0.1, mean 0.01. fp32 (TF32 off): 1e-3.
LM_BF16_MAX, LM_BF16_MEAN, LM_F32_MAX = 1e-1, 1e-2, 1e-3
# the MoE LM: a token whose top-2 gates nearly tie may take another expert
# when attention rounds differently, and then moves by O(1); rounding alone
# moves a token by at most ~0.1 (CPU rehearsal at L=512). So: the mean as
# the LM's, and at most 1% of tokens moved by more than 0.25, not a bound
# on the worst token
MOE_MEAN, MOE_MOVED, MOE_SHARE_MOVED = 1e-2, 0.25, 0.01
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


def _bound(nbytes: int, ops: int, peak_ops_s: float = PEAK_FP32_S):
    """(bound ms, what bounds it) from the bytes moved and the operations
    done, at the card's published peaks (fp32 unless ``peak_ops_s``)."""
    bytes_ms, ops_ms = nbytes / PEAK_BYTES_S * 1e3, ops / peak_ops_s * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms \
        else "operations"


def _ptxas_of(kernel):
    """ptxas's registers and spill bytes of each function of ``kernel``'s
    library, demangled, from its build log."""
    from mmlspark_tpu_torch.kernels import build
    report = build.ptxas_report(kernel.build_log)
    return dict(zip(build.demangle(list(report)), report.values()))


def _floor_ms(torch, fn):
    """Device time of an empty kernel on a kernel's grid (``fn(stream)``
    launches it on the current stream, the one a graph captures): the floor
    the kernel cannot go below."""
    def launch():
        stream = torch.cuda.current_stream().cuda_stream
        _check(fn(stream) == 0, "an empty floor kernel failed to launch")
    return _graph_ms(torch, launch)


def phase_kernel_check_k1(torch, tpre, kernel, card):
    """K1 against its plain version at its three shapes (bit-equal
    required); times, bound and launch floor (an empty kernel on the same
    grid) at each, and at the train shape K1 over the 16 distinct batch
    slices of a resident epoch as the train step reads them. Returns the
    train shape's bf16 row, with the f32 time beside it."""
    from ctypes import c_int, c_longlong, c_void_p
    empty = kernel.symbol("fused_normalize_empty",
                          [c_longlong, c_int, c_int, c_void_p])
    shapes = [("train_bf16", (TRAIN_BATCH, math.prod(TRAIN_SHAPE)),
               torch.bfloat16, CIFAR_MEAN, CIFAR_STD),
              ("train_f32", (TRAIN_BATCH, math.prod(TRAIN_SHAPE)),
               torch.float32, CIFAR_MEAN, CIFAR_STD),
              ("train_large_bf16", (128, 224 * 224 * 3), torch.bfloat16,
               (127.5,) * 3, (127.5,) * 3)]
    rows = {}
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
        bf16 = int(dt == torch.bfloat16)
        floor_ms = _floor_ms(torch, lambda s: empty(u8.numel(), 3, bf16, s))
        out_size = torch.empty((), dtype=dt).element_size()
        nbytes = u8.numel() * (1 + out_size) + sum(
            t.numel() * t.element_size() for t in consts)
        bound_ms, bound_by = _bound(nbytes, K1_OPS_PER_ELEMENT * u8.numel())
        rows[name] = dict(
            variant=name, shape=list(shape),
            out_dtype=str(dt).replace("torch.", ""), max_abs_err=max_err,
            ms=kernel_ms, plain_ms=plain_ms, eager_ms=eager_ms,
            floor_ms=floor_ms, bound_ms=bound_ms, bound_by=bound_by,
            bytes=nbytes, bound_share=bound_ms / kernel_ms,
            over_floor_ms=kernel_ms - floor_ms)

    # the train step's reads: 16 distinct batch slices of a resident epoch
    # of 4,096 images, against one slice replayed (the rows above)
    epoch = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (TRAIN_ROWS, math.prod(TRAIN_SHAPE)), dtype=np.uint8)).to(card)
    slices = [epoch[i:i + TRAIN_BATCH]
              for i in range(0, TRAIN_ROWS, TRAIN_BATCH)]
    consts = (torch.tensor(CIFAR_MEAN, dtype=torch.float32, device=card),
              torch.from_numpy(tpre._inv_std(CIFAR_STD)).to(card))
    turn = iter(range(10 ** 9))
    epoch_ms = _graph_ms(torch, lambda: tpre.fused_normalize(
        slices[next(turn) % len(slices)], *consts, torch.bfloat16),
        iters=len(slices))
    rows["train_bf16"]["epoch_slices_ms"] = epoch_ms
    ptxas = _ptxas_of(kernel)
    _line(phase="kernel_check", kernel=kernel.name,
          launches_while_checking=kernel.launches,
          variant_launches_while_checking=dict(kernel.variant_launches),
          variants=list(rows.values()),
          epoch_slices=dict(slices=len(slices), ms=epoch_ms,
                            one_slice_replayed_ms=rows["train_bf16"]["ms"]),
          ptxas=ptxas,
          library="none: no single PyTorch call computes a per-channel "
                  "uint8 normalize with a bf16 or f32 store")
    main = dict(rows["train_bf16"])
    main.update(ms_f32=rows["train_f32"]["ms"],
                floor_ms_f32=rows["train_f32"]["floor_ms"],
                bound_ms_f32=rows["train_f32"]["bound_ms"],
                ms_large_bf16=rows["train_large_bf16"]["ms"],
                bound_ms_large_bf16=rows["train_large_bf16"]["bound_ms"],
                ptxas=ptxas)
    return main


def phase_kernel_check(torch, tpre, kernel, card):
    """K2 against its plain version at the main path's geometries; at the
    main shape (256² → 224²) in bf16, the featurize path's output, and
    f32: times, bound, launch floor (an empty kernel on the same grid),
    the direct-load variant's time beside the staged one, and
    ``F.interpolate``'s. Returns the bf16 row with the f32 numbers."""
    from ctypes import c_int, c_void_p
    empty = kernel.symbol("crop_resize_normalize_empty",
                          [c_int, c_int, c_int, c_void_p])
    raw = np.random.default_rng(1).integers(
        0, 256, (BATCH, SRC, SRC, 3), dtype=np.uint8)
    u8 = torch.from_numpy(raw).to(card)
    variants = [
        ("resize_bf16", None, (DST, DST), torch.bfloat16),
        ("resize", None, (DST, DST), torch.float32),
        ("crop_resize", (240, 240), (DST, DST), torch.float32),
        ("crop_resize_bf16", (240, 240), (DST, DST), torch.bfloat16),
        ("crop_only", (DST, DST), None, torch.float32),
        ("crop_only_bf16", (DST, DST), None, torch.bfloat16),
    ]
    xf = u8.permute(0, 3, 1, 2).float()   # NCHW view, channels-last
    library_ms = _graph_ms(torch, lambda: torch.nn.functional.interpolate(
        xf, size=(DST, DST), mode="bilinear", align_corners=False,
        antialias=False))
    rows = {}
    for name, crop, resize, dt in variants:
        plan = tpre.CropResizePlan((SRC, SRC, 3), resize=resize, crop=crop,
                                   mean=IMAGENET_MEAN, std=IMAGENET_STD)
        before = kernel.variant_launches.get("staged", 0)
        got = tpre.crop_resize_normalize(u8, plan, dt)
        _check(kernel.variant_launches.get("staged", 0) == before + 1,
               f"K2 {name}: the staged variant did not launch")
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
                   band_rows=plan.band_rows, stage_max=plan.stage_max,
                   smem_bytes=plan.smem_bytes(plan.stage_max),
                   max_abs_err=max_err, max_quanta=quanta,
                   share_differing=share, tolerance=tol)
        if name.startswith("resize"):
            direct = tpre.CropResizePlan(
                (SRC, SRC, 3), resize=resize, crop=crop, mean=IMAGENET_MEAN,
                std=IMAGENET_STD, smem_budget=0)
            same = tpre.crop_resize_normalize(u8, direct, dt)
            _check(bool(torch.equal(same, got)),
                   f"K2 {name}: the direct-load variant differs from the "
                   "staged one")
            kernel_ms = _graph_ms(
                torch, lambda: tpre.crop_resize_normalize(u8, plan, dt))
            direct_ms = _graph_ms(
                torch, lambda: tpre.crop_resize_normalize(u8, direct, dt))
            plain_ms = _graph_ms(
                torch, lambda: tpre._crop_resize_normalize_plain(u8, plan, dt))
            eager_ms = _median_ms(
                torch, lambda: tpre.crop_resize_normalize(u8, plan, dt))
            floor_ms = _floor_ms(
                torch, lambda s: empty(BATCH, DST, plan.band_rows, s))
            nbytes = plan.bytes_moved(BATCH, dt) + sum(
                t.numel() * t.element_size() for t in plan.on(card))
            ops = K2_OPS_PER_ELEMENT * BATCH * DST * DST * 3
            bound_ms, bound_by = _bound(nbytes, ops)
            row.update(ms=kernel_ms, direct_ms=direct_ms, plain_ms=plain_ms,
                       library_ms=library_ms, eager_ms=eager_ms,
                       floor_ms=floor_ms, bound_ms=bound_ms,
                       bound_by=bound_by, bytes=nbytes, ops=ops,
                       bound_share=bound_ms / kernel_ms)
        rows[name] = row
    ptxas = _ptxas_of(kernel)
    _line(phase="kernel_check", kernel=kernel.name, shape=[BATCH, SRC, SRC, 3],
          launches_while_checking=kernel.launches,
          variant_launches_while_checking=dict(kernel.variant_launches),
          variants=list(rows.values()), ptxas=ptxas,
          library="F.interpolate bilinear on the float NCHW view "
                  "(resample only)")
    main = dict(rows["resize_bf16"])
    f32 = rows["resize"]
    main.update(ms_f32=f32["ms"], direct_ms_f32=f32["direct_ms"],
                plain_ms_f32=f32["plain_ms"], floor_ms_f32=f32["floor_ms"],
                bound_ms_f32=f32["bound_ms"],
                max_abs_err_f32=f32["max_abs_err"], ptxas=ptxas)
    return main


def _bf16_steps(got, want):
    """The largest |got - want| beyond K3_F32_TOL, in bf16 steps (ulps) of
    the larger magnitude: at most 1 passes."""
    g, w = got.float(), want.float()
    mag = g.abs().maximum(w.abs())
    ulp = (mag.log2().floor() - 7).exp2().clamp(min=2.0 ** -133)
    return (((g - w).abs() - K3_F32_TOL).clamp(min=0) / ulp).max().item()


def _tc_gate(got, want, v):
    """(worst |got - want| over its bound, mean |got - want| over its
    ceiling) for K3's tensor-core route: both at most 1 pass."""
    g, w = got.float(), want.float()
    mag = g.abs().maximum(w.abs())
    step = (mag.log2().floor() - 7).exp2().clamp(min=2.0 ** -133)
    diff = (g - w).abs()
    bound = TC_P_ROUNDING * v.float().abs().max() + K3_F32_TOL + step
    return ((diff / bound).max().item(),
            (diff.mean() / (TC_MEAN_CEILING * w.abs().mean())).item())


def phase_kernel_check_k3(torch, tatt, kernels, card):
    """K3 against its plain version at the LM's shape (bf16 and f32), the
    JAX bench's longctx shape and other head dims, each through the
    route ``_route`` picks; both K3 kernels' launches are counted across the
    routed call (the route's kernel once, the other never) and across the
    plain call (neither). Times, the library call's time and the bound at
    each. Returns the LM shape's row of each route."""
    import torch.nn.functional as F
    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 products in fp32
    ks = {"tc": kernels.FLASH_ATTENTION_TC, "f32": kernels.FLASH_ATTENTION}
    lm = (LM_BATCH, LM_LEN, 8, 64)
    variants = [("lm_bf16", lm, torch.bfloat16, True),
                ("lm_f32", lm, torch.float32, True),
                ("longctx_bf16", (1, 8192, 8, 64), torch.bfloat16, True),
                ("d16_bf16", (8, 512, 8, 16), torch.bfloat16, False),
                ("lm_d128_bf16", (LM_BATCH, LM_LEN, 4, 128), torch.bfloat16,
                 True),
                ("d512_f32", (2, 512, 4, 512), torch.float32, True),
                ("lm_d128_f32", (LM_BATCH, LM_LEN, 4, 128), torch.float32,
                 True),
                # the CUDA-core route's bf16 input; SDPA runs it on the
                # tensor cores
                ("d256_bf16", (2, LM_LEN, 4, 256), torch.bfloat16, True)]

    def counted(fn):
        before = {r: k.launches for r, k in ks.items()}
        out = fn()
        return out, {r: k.launches - before[r] for r, k in ks.items()}

    rows, main = [], {}
    for name, shape, dt, causal in variants:
        rng = np.random.default_rng(8)
        q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                   .to(card, dt) for _ in range(3))
        b, L, h, d = shape
        route = tatt._route(dt, d)
        got, got_launches = counted(
            lambda: tatt.flash_attention(q, k, v, causal=causal))
        want, want_launches = counted(
            lambda: tatt.flash_attention_plain(q, k, v, causal))
        torch.cuda.synchronize()
        _check(got_launches == {r: int(r == route) for r in ks}
               and want_launches == {r: 0 for r in ks},
               f"K3 {name}: route {route}, launches {got_launches} across "
               f"the kernel call and {want_launches} across the plain call")
        max_err = (got.float() - want.float()).abs().max().item()
        steps = _bf16_steps(got, want)
        gate = None
        if dt == torch.float32:
            ok = max_err <= K3_F32_TOL
        elif route == "tc":
            gate = _tc_gate(got, want, v)
            ok = gate[0] <= 1.0 and gate[1] <= 1.0
        else:
            ok = steps <= 1.0
        _check(ok and got.dtype == dt and bool(torch.isfinite(
            got.float()).all()), f"K3 {name} ({route}): max err {max_err} "
                                 f"({steps} bf16 steps, gate {gate}) against "
                                 "its plain version")
        plain_iters = 2 if L >= 8192 else 5
        kernel_ms = _graph_ms(
            torch, lambda: tatt.flash_attention(q, k, v, causal=causal))
        plain_ms = _graph_ms(
            torch, lambda: tatt.flash_attention_plain(q, k, v, causal),
            iters=plain_iters, reps=3)
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = _graph_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal))
        eager_ms = _median_ms(
            torch, lambda: tatt.flash_attention(q, k, v, causal=causal))
        # the causal-useful FLOPs (bench.py's longctx count): two products
        # of 2 D operations per (query, key) pair the mask keeps
        pairs = L * (L + 1) // 2 if causal else L * L
        flops = 4 * b * h * d * pairs
        nbytes = 4 * q.numel() * q.element_size()
        bound_ms, bound_by = _bound(
            nbytes, flops, PEAK_BF16_S if dt == torch.bfloat16
            else PEAK_FP32_S)
        row = dict(variant=name, route=route, kernel=ks[route].name,
                   shape=list(shape), causal=causal,
                   dtype=str(dt).replace("torch.", ""),
                   launches_kernel_call=got_launches,
                   launches_plain_call=want_launches, max_abs_err=max_err,
                   mean_abs_err=(got.float() - want.float()).abs().mean()
                   .item(), bf16_steps_beyond_f32_tol=steps,
                   tc_gate_worst_over_bound=None if gate is None else gate[0],
                   tc_gate_mean_over_ceiling=None if gate is None
                   else gate[1], ms=kernel_ms, eager_ms=eager_ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   over_library=kernel_ms / library_ms, bound_ms=bound_ms,
                   bound_by=bound_by, flops=flops, bytes=nbytes,
                   tflops=flops / kernel_ms / 1e9,
                   bound_share=bound_ms / kernel_ms)
        rows.append(row)
        main.setdefault(route, row)
    _line(phase="kernel_check", kernel="flash_attention (both routes)",
          launches_while_checking={r: k.launches for r, k in ks.items()},
          variants=rows,
          library="F.scaled_dot_product_attention on (B, H, L, D) views, "
                  "a yardstick the port never calls", tf32="off")
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
    k2_variants = dict(kernels.CROP_RESIZE_NORMALIZE.variant_launches)
    _check(launches == want and k2_variants == {"staged": batches},
           f"kernels launched {launches} times on the featurize path "
           f"(K2's variants {k2_variants}), want {want} (K2's staged "
           "variant once per batch, no other kernel)")

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
          launches_main_path=launches, k2_variant_launches=k2_variants,
          k2_out_dtype="bfloat16", first_pass_s=first_s,
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


def _lm_reference(torch, card, name, state, ids, batch, **arch):
    """``hidden`` of the same module and weights with the reference
    attention (``full_attention(use_flash="never")``), scored batch by batch
    on the card: float32 numpy."""
    from functools import partial

    from mmlspark_tpu_torch.models.zoo import build_model
    from mmlspark_tpu_torch.parallel.sequence import full_attention
    module = build_model(name, attention_fn=partial(
        full_attention, use_flash="never"), **arch)["module"]
    module.load_state_dict({k: torch.from_numpy(np.asarray(v))
                            for k, v in state.items()})
    module = module.to(card).eval()
    out = []
    with torch.inference_mode():
        for i in range(0, len(ids), batch):
            x = torch.from_numpy(ids[i:i + batch]).to(card)
            _, inters = module.forward_with_intermediates(
                x, layers=("hidden",))
            out.append(inters["hidden"].float().cpu().numpy())
    return np.concatenate(out)


def _lm_scorer(name, node, batch, **arch):
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    tm = TorchModel(inputCol="ids", outputCol="h", outputNodeName=node,
                    miniBatchSize=batch, deviceCache="on")
    return tm.set_model(name, seed=0, **arch)


def _diff_stats(got, want):
    """|got - want| over (rows, L, dim): max, mean, and the share of tokens
    whose largest difference exceeds 5e-2 and MOE_MOVED."""
    d = np.abs(got - want)
    token = d.max(axis=-1)
    return dict(max_abs=float(d.max()), mean_abs=float(d.mean()),
                share_tokens_over_5e_2=float((token > 5e-2).mean()),
                share_tokens_moved=float((token > MOE_MOVED).mean()))


def phase_lm_score(torch, kernels, card, profile_dir=None):
    """The attention path through the public entry point: TorchModel scores
    token ids through transformer_lm for ``hidden`` (the counts zeroed just
    before, read just after), its tokens/s over 3 warm passes, and its
    agreement with the reference-attention route in bf16 and fp32."""
    from mmlspark_tpu_torch.core.frame import Frame
    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 products in fp32
    ids = np.random.default_rng(0).integers(
        0, LM_VOCAB, (LM_ROWS, LM_LEN)).astype(np.int32)
    frame = Frame.from_dict({"ids": ids})
    batches = math.ceil(LM_ROWS / LM_BATCH)

    def want_launches(n, kernel=kernels.FLASH_ATTENTION_TC):
        """n launches of one K3 route (bf16: the tensor cores), none of any
        other kernel"""
        want = {k.name: 0 for k in kernels.KERNELS}
        want[kernel.name] = n
        return want

    # the main path: counts zeroed just before, read just after
    tm = _lm_scorer("transformer_lm", "hidden", LM_BATCH)
    kernels.reset_launches()
    t0 = time.perf_counter()
    hidden = np.asarray(tm.transform(frame).column("h"))
    first_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.KERNELS}
    _check(launches == want_launches(LM_DEPTH * batches),
           f"kernels launched {launches} times on the lm_score path, want "
           f"K3's tensor-core kernel {LM_DEPTH} layers x {batches} batches "
           "and no other kernel")
    _check(hidden.shape == (LM_ROWS, LM_LEN, 512)
           and bool(np.isfinite(hidden).all()),
           f"hidden {hidden.shape} not finite or of the wrong shape")

    pass_s, repeat_diff = [], 0.0
    for _ in range(3):
        kernels.reset_launches()
        t0 = time.perf_counter()
        again = np.asarray(tm.transform(frame).column("h"))
        pass_s.append(time.perf_counter() - t0)
        _check({k.name: k.launches for k in kernels.KERNELS}
               == want_launches(LM_DEPTH * batches),
               "a warm pass did not launch K3's tensor-core kernel once per "
               "layer and batch")
        repeat_diff = max(repeat_diff, float(np.abs(again - hidden).max()))
    _check(repeat_diff <= 1e-5, f"a repeat pass moved hidden by {repeat_diff}")
    if profile_dir:
        _profile_pass(torch, lambda: tm.transform(frame), profile_dir,
                      "lm_score")
    tokens_s = [LM_ROWS * LM_LEN / s for s in pass_s]

    ref = _lm_reference(torch, card, "transformer_lm", tm._state["params"],
                        ids, LM_BATCH)
    bf16 = _diff_stats(hidden, ref)
    _check(bf16["max_abs"] <= LM_BF16_MAX and bf16["mean_abs"] <= LM_BF16_MEAN,
           f"bf16 hidden vs the reference-attention route: {bf16}")

    # fp32 (dtype=float32, TF32 off): both routes compute in fp32, K3 on
    # its CUDA-core kernel
    ids32 = ids[:LM_F32_ROWS]
    tm32 = _lm_scorer("transformer_lm", "hidden", LM_BATCH, dtype="float32")
    frame32 = Frame.from_dict({"ids": ids32})
    want32 = want_launches(LM_DEPTH * LM_F32_ROWS // LM_BATCH,
                           kernels.FLASH_ATTENTION)
    kernels.reset_launches()
    h32 = np.asarray(tm32.transform(frame32).column("h"))
    launches32 = {k.name: k.launches for k in kernels.KERNELS}
    _check(launches32 == want32,
           f"fp32 pass: kernels launched {launches32} times, want K3's "
           "CUDA-core kernel once per layer and batch and no other kernel")
    # one warm fp32 pass, timed
    kernels.reset_launches()
    t0 = time.perf_counter()
    again32 = np.asarray(tm32.transform(frame32).column("h"))
    pass32_s = time.perf_counter() - t0
    _check({k.name: k.launches for k in kernels.KERNELS} == want32
           and float(np.abs(again32 - h32).max()) <= 1e-5,
           "the warm fp32 pass launched other kernels or moved hidden")
    ref32 = _lm_reference(torch, card, "transformer_lm", tm32._state["params"],
                          ids32, LM_BATCH, dtype="float32")
    f32 = _diff_stats(h32, ref32)
    _check(f32["max_abs"] <= LM_F32_MAX,
           f"fp32 hidden vs the reference-attention route: {f32}")

    # the default output (logits) on 2 rows: the tied fp32 head of the same
    # hidden
    lg_tm = _lm_scorer("transformer_lm", "", 2)
    logits = np.asarray(lg_tm.transform(Frame.from_dict({"ids": ids[:2]}))
                        .column("h"))
    table = torch.from_numpy(np.asarray(
        tm._state["params"]["token_embedding.embedding"])).to(card)
    with torch.inference_mode():
        want_lg = torch.einsum("bld,vd->blv", torch.from_numpy(
            hidden[:2]).to(card), table).cpu().numpy()
    lg_err = float(np.abs(logits - want_lg).max() / np.abs(want_lg).max())
    _check(logits.shape == (2, LM_LEN, LM_VOCAB)
           and bool(np.isfinite(logits).all()) and lg_err <= 1e-5,
           f"logits {logits.shape}: rel err {lg_err} against the head of "
           "the scored hidden")

    _line(phase="lm_score", card=_smi(), model="transformer_lm",
          rows=LM_ROWS, length=LM_LEN, batch=LM_BATCH, compute="bfloat16",
          launches_main_path=launches, k3_launches_per_pass=LM_DEPTH * batches,
          launches_fp32_pass=launches32,
          first_pass_s=first_s, timed_pass_s=pass_s,
          tokens_per_s=statistics.median(tokens_s),
          tokens_per_s_min=min(tokens_s), tokens_per_s_max=max(tokens_s),
          repeat_max_abs_diff=repeat_diff, bf16_vs_reference=bf16,
          bf16_limits=dict(max_abs=LM_BF16_MAX, mean_abs=LM_BF16_MEAN),
          fp32_rows=LM_F32_ROWS, fp32_vs_reference=f32,
          fp32_limit=LM_F32_MAX, fp32_warm_pass_s=pass32_s,
          fp32_tokens_per_s=LM_F32_ROWS * LM_LEN / pass32_s,
          logits_rel_err=lg_err, tf32="off")
    return launches, launches32


def phase_moe_score(torch, kernels, card):
    """transformer_lm_moe at the zoo's defaults over 16 rows at batch 8,
    untimed: K3 once per layer and batch, ``hidden`` against the
    reference-attention route."""
    from mmlspark_tpu_torch.core.frame import Frame
    ids = np.random.default_rng(0).integers(
        0, LM_VOCAB, (MOE_ROWS, LM_LEN)).astype(np.int32)
    tm = _lm_scorer("transformer_lm_moe", "hidden", LM_BATCH)
    kernels.reset_launches()
    t0 = time.perf_counter()
    hidden = np.asarray(tm.transform(Frame.from_dict({"ids": ids}))
                        .column("h"))
    pass_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.KERNELS}
    want = {k.name: 0 for k in kernels.KERNELS}
    want[kernels.FLASH_ATTENTION_TC.name] = LM_DEPTH * MOE_ROWS // LM_BATCH
    _check(launches == want, f"kernels launched {launches} times on the "
                             f"moe_score path, want {want}")
    _check(hidden.shape == (MOE_ROWS, LM_LEN, 512)
           and bool(np.isfinite(hidden).all()), "MoE hidden shape/finite")
    ref = _lm_reference(torch, card, "transformer_lm_moe", tm._state["params"],
                        ids, LM_BATCH)
    stats = _diff_stats(hidden, ref)
    _check(stats["mean_abs"] <= MOE_MEAN
           and stats["share_tokens_moved"] <= MOE_SHARE_MOVED,
           f"MoE bf16 hidden vs the reference-attention route: {stats}")
    _line(phase="moe_score", card=_smi(), model="transformer_lm_moe",
          rows=MOE_ROWS, length=LM_LEN, batch=LM_BATCH,
          launches_main_path=launches, pass_s=pass_s,
          tokens_per_s_untimed_pass=MOE_ROWS * LM_LEN / pass_s,
          bf16_vs_reference=stats,
          limits=dict(mean_abs=MOE_MEAN, moved_over=MOE_MOVED,
                      share_tokens_moved=MOE_SHARE_MOVED))


def phase_featurize_vit(torch, kernels, card):
    """ViT-B/16 features of 128 uint8 images, untimed: ImageFeaturizer
    (K2 resizes 256 -> 224) and TorchModel with a center crop to 224 on the
    card (K2), each against the plain-preprocess route."""
    from mmlspark_tpu_torch.core.frame import Frame
    from mmlspark_tpu_torch.core.schema import ColumnSchema, DType, ImageValue
    from mmlspark_tpu_torch.image.featurizer import ImageFeaturizer
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    from mmlspark_tpu_torch.models.zoo import build_model
    from mmlspark_tpu_torch.ops.preprocess import (
        CropResizePlan, _crop_resize_normalize_plain,
    )

    raw = np.random.default_rng(7).integers(
        0, 256, size=(VIT_IMAGES, SRC, SRC, 3), dtype=np.uint8)
    imgs = np.empty(VIT_IMAGES, dtype=object)
    for i in range(VIT_IMAGES):
        imgs[i] = ImageValue(path=f"mem://vit/{i}", data=raw[i])
    frame = Frame.from_dict({"row": np.arange(VIT_IMAGES)}).with_column_values(
        ColumnSchema("image", DType.IMAGE), imgs)
    flat = Frame.from_dict({"u8": raw.reshape(VIT_IMAGES, -1)})
    batches = math.ceil(VIT_IMAGES / VIT_BATCH)
    norm = dict(input_mean=(127.5,) * 3, input_std=(127.5,) * 3)

    def route(run):
        kernels.reset_launches()
        t0 = time.perf_counter()
        feats = np.asarray(run())
        seconds = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels.KERNELS}
        want = {k.name: 0 for k in kernels.KERNELS}
        want[kernels.CROP_RESIZE_NORMALIZE.name] = batches
        _check(launches == want, f"featurize_vit: kernels launched "
                                 f"{launches} times, want {want}")
        _check(feats.shape == (VIT_IMAGES, 768)
               and bool(np.isfinite(feats).all()), "ViT features")
        return feats, seconds, launches

    fz = ImageFeaturizer(inputCol="image", outputCol="f", cutOutputLayers=1,
                         miniBatchSize=VIT_BATCH)
    fz.set_model("vit_b16", seed=0, **norm)
    resized, resize_s, launches = route(
        lambda: fz.transform(frame).column("f"))
    tm = TorchModel(inputCol="u8", outputCol="f", outputNodeName="pool",
                    miniBatchSize=VIT_BATCH, devicePreprocess={
                        "srcShape": [SRC, SRC, 3], "crop": [DST, DST]})
    tm.set_model("vit_b16", params=fz._state["params"], **norm)
    cropped, crop_s, _ = route(lambda: tm.transform(flat).column("f"))

    module = build_model("vit_b16")["module"]
    module.load_state_dict({k: torch.from_numpy(np.asarray(v))
                            for k, v in fz._state["params"].items()})
    module = module.to(card).eval()

    def plain(resize, crop):
        plan = CropResizePlan((SRC, SRC, 3), resize=resize, crop=crop,
                              mean=(127.5,) * 3, std=(127.5,) * 3)
        out = []
        with torch.inference_mode():
            for i in range(0, VIT_IMAGES, VIT_BATCH):
                x = _crop_resize_normalize_plain(
                    torch.from_numpy(raw[i:i + VIT_BATCH]).to(card), plan)
                out.append(module.forward_features(x).float().cpu().numpy())
        return np.concatenate(out)

    errs = {}
    for name, got, want in (("resize", resized, plain((DST, DST), None)),
                            ("crop", cropped, plain(None, (DST, DST)))):
        errs[name] = float(np.abs(got - want).max() / np.abs(want).max())
        # the featurize phase's bf16 limit: 2% of the features' scale
        _check(errs[name] <= 0.02, f"ViT {name} features vs the plain-"
                                   f"preprocess route: rel err {errs[name]}")
    _line(phase="featurize_vit", card=_smi(), model="vit_b16",
          images=VIT_IMAGES, batch=VIT_BATCH, src=[SRC, SRC, 3],
          dst=[DST, DST], launches_main_path=launches,
          rel_err_vs_plain_preprocess=errs, limit=0.02,
          images_per_s_untimed=dict(resize=VIT_IMAGES / resize_s,
                                    crop=VIT_IMAGES / crop_s))


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
    from mmlspark_tpu_torch.ops import attention as tatt
    from mmlspark_tpu_torch.ops import preprocess as tpre

    smi = _smi()
    _line(phase="device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, cudnn=torch.backends.cudnn.version())

    t0 = time.perf_counter()
    status = kernels.build_all()
    ptxas = {}
    for k in kernels.KERNELS:
        report = kernels.build.ptxas_report(k.build_log)
        ptxas[k.name] = dict(zip(kernels.build.demangle(list(report)),
                                 report.values()))
    _line(phase="build", seconds=time.perf_counter() - t0, status=status,
          cache_hit=all(v == "hit" for v in status.values()), ptxas=ptxas)
    # every instantiation of every kernel keeps its values in registers
    for k in kernels.KERNELS:
        _check(bool(ptxas[k.name]), f"{k.name}: no ptxas report in its "
                                    "build log")
        spills = {fn: r for fn, r in ptxas[k.name].items()
                  if r["spill_stores"] or r["spill_loads"]}
        _check(not spills, f"{k.name} spills: {spills}")

    card = torch.device("cuda", 0)
    k1 = phase_kernel_check_k1(torch, tpre, kernels.FUSED_NORMALIZE, card)
    k2 = phase_kernel_check(torch, tpre, kernels.CROP_RESIZE_NORMALIZE, card)
    k3 = phase_kernel_check_k3(torch, tatt, kernels, card)
    profile_dir = None
    if "--profile" in sys.argv[1:]:
        profile_dir = sys.argv[sys.argv.index("--profile") + 1]
    featurize = phase_featurize(torch, kernels, card, profile_dir)
    train = phase_train(torch, kernels, card, profile_dir)
    phase_deep(torch, card)
    lm, lm32 = phase_lm_score(torch, kernels, card, profile_dir)
    phase_moe_score(torch, kernels, card)
    phase_featurize_vit(torch, kernels, card)

    k1k, k2k = kernels.FUSED_NORMALIZE, kernels.CROP_RESIZE_NORMALIZE
    tc, f32 = kernels.FLASH_ATTENTION_TC, kernels.FLASH_ATTENTION
    _line(kernels=[{
        "name": k1k.name, "route": "cuda",
        "source": "mmlspark_tpu_torch/kernels/csrc/fused_normalize.cu",
        "replaces": "mmlspark_tpu/ops/pallas_preprocess.py:43",
        "launches": train[k1k.name], "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes this function",
        "shape": "B=256, 32x32x3 uint8 -> bf16 (the train step's)",
        "ms_bf16": k1["ms"], "floor_ms": k1["floor_ms"],
        "ms_f32": k1["ms_f32"], "floor_ms_f32": k1["floor_ms_f32"],
        "bound_ms_f32": k1["bound_ms_f32"],
        "epoch_slices_ms": k1["epoch_slices_ms"],
        "ms_train_large_bf16": k1["ms_large_bf16"],
        "bound_ms_train_large_bf16": k1["bound_ms_large_bf16"],
        "registers": {f: r["registers"] for f, r in k1["ptxas"].items()}}, {
        "name": k2k.name, "route": "cuda",
        "source": "mmlspark_tpu_torch/kernels/csrc/crop_resize_normalize.cu",
        "replaces": "mmlspark_tpu/ops/pallas_preprocess.py:147",
        "launches": featurize[k2k.name], "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
        "library_ms": k2["library_ms"],
        "library_note": "F.interpolate bilinear on float input, resample "
                        "only",
        "shape": "B=128, 256x256x3 uint8 -> 224x224x3 bf16 (the featurize "
                 "path's)",
        "ms_bf16": k2["ms"], "floor_ms": k2["floor_ms"],
        "direct_ms": k2["direct_ms"], "ms_f32": k2["ms_f32"],
        "direct_ms_f32": k2["direct_ms_f32"],
        "plain_ms_f32": k2["plain_ms_f32"],
        "bound_ms_f32": k2["bound_ms_f32"],
        "max_abs_err_f32": k2["max_abs_err_f32"],
        "share_differing": k2["share_differing"],
        "registers": {f: r["registers"] for f, r in k2["ptxas"].items()}}, {
        "name": tc.name, "route": "cuda",
        "source": "mmlspark_tpu_torch/kernels/csrc/flash_attention_wgmma.cu",
        "replaces": "mmlspark_tpu/ops/pallas_attention.py:109",
        "launches": lm[tc.name], "max_abs_err": k3["tc"]["max_abs_err"],
        "ms": k3["tc"]["ms"], "plain_ms": k3["tc"]["plain_ms"],
        "bound_ms": k3["tc"]["bound_ms"], "bound_by": k3["tc"]["bound_by"],
        "library_ms": k3["tc"]["library_ms"],
        "library_note": "F.scaled_dot_product_attention(is_causal=True), "
                        "bf16 (B=8, L=2048, H=8, D=64)"}, {
        "name": f32.name, "route": "cuda",
        "source": "mmlspark_tpu_torch/kernels/csrc/flash_attention.cu",
        "replaces": "mmlspark_tpu/ops/pallas_attention.py:109",
        "launches": lm32[f32.name],
        "launches_note": "lm_score's fp32 pass (16 rows): f32 is this "
                         "route's input; the bf16 main path launches it 0 "
                         "times",
        "max_abs_err": k3["f32"]["max_abs_err"],
        "ms": k3["f32"]["ms"], "plain_ms": k3["f32"]["plain_ms"],
        "bound_ms": k3["f32"]["bound_ms"], "bound_by": k3["f32"]["bound_by"],
        "library_ms": k3["f32"]["library_ms"],
        "library_note": "F.scaled_dot_product_attention(is_causal=True), "
                        "f32, TF32 off (B=8, L=2048, H=8, D=64)"}])
    print(_smi(), flush=True)
    _line(ok=True, device={"platform": "gpu",
                           "kind": torch.cuda.get_device_name(0),
                           "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
