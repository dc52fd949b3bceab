#!/usr/bin/env python3
"""Time variants of the preprocess kernels K1 and K2 on one card, in turns.

    python3 preprocess_variants.py --k1 waves2=kWaves:2 \
        --k2 t128=kThreads:128 --k2 band16=band_rows:16 \
        --parent-csrc .tree_parent/mmlspark_tpu_torch/kernels/csrc

A variant is the committed ``fused_normalize.cu`` (``--k1``) or
``crop_resize_normalize.cu`` (``--k2``) with some ``constexpr int NAME =
value;`` lines replaced: ``NAME=CONST:VALUE[,CONST:VALUE...]``. For K2,
``band_rows:N`` sets the plan's ``K2_BAND_ROWS`` instead, and
``source:PATH`` starts from another source with the same entry point. The
committed sources run as ``committed``; with ``--parent-csrc`` the two
sources of an earlier tree (K2 with its earlier entry point, which took
no band tables) run as ``parent``. Every source is built as the kernels
are (nvcc, one process per source, all at once, into the build
directory), its ptxas report is printed, and each is held against the
plain version (K1 bit-equal, K2 under chip_smoke.py's gate) and timed as
``chip_smoke.py`` times kernels (device time of CUDA-graph replays) at the
main paths' shapes, in two rounds, the second in reverse order. Prints one
JSON line per (round, variant, shape), then the card's name and power
limit. Fails without CUDA or if a variant misses its gate.
"""
from __future__ import annotations

import argparse
import re
import sys
from ctypes import c_int, c_void_p
from pathlib import Path

import numpy as np

import chip_smoke as cs

K1_SHAPES = [("train_bf16", (cs.TRAIN_BATCH, 3072), "bfloat16"),
             ("train_f32", (cs.TRAIN_BATCH, 3072), "float32"),
             ("train_large_bf16", (128, 224 * 224 * 3), "bfloat16")]
K2_SHAPES = [("resize_bf16", "bfloat16"), ("resize", "float32")]
# the earlier K2 entry point: (src, dst, y0, y1, fy, x0, x1, fx, mean, istd,
# b, hs, ws, hd, wd, c, out_bf16, stream)
PARENT_K2_ARGTYPES = [c_void_p] * 10 + [c_int] * 7 + [c_void_p]


def variant_source(source: str, spec: str):
    """(``source`` with each ``CONST:VALUE`` of ``spec`` replaced in its
    ``constexpr int CONST = ...;`` line, the Python-side settings)."""
    settings = {}
    for part in filter(None, spec.split(",")):
        name, value = (p.strip() for p in part.split(":", 1))
        if name in ("band_rows", "source"):
            settings[name] = value
            continue
        line = re.compile(rf"constexpr int {name} = [^;]*;")
        if not line.search(source):
            raise ValueError(f"no 'constexpr int {name}' line")
        source = line.sub(f"constexpr int {name} = {int(value)};", source)
    return source, settings


def _kernels(kernel, specs, parent_dir, argtypes):
    """[(name, Kernel, settings)] for the committed source, each spec and
    the parent's source; the Kernels are kept out of the registry."""
    from mmlspark_tpu_torch.kernels import build
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    found = [("committed", kernel, {})]
    for spec in specs:
        name, _, fields = spec.partition("=")
        base = re.search(r"(?:^|,)\s*source:([^,]+)", fields)
        source, settings = variant_source(
            Path(base.group(1).strip()).read_text() if base
            else kernel.source.read_text(), fields)
        path = out_dir / f"{kernel.source.stem}_{name}.cu"
        path.write_text(source)
        found.append((name, build.Kernel(kernel.name, path, argtypes),
                      settings))
    if parent_dir:
        found.append(("parent", build.Kernel(
            kernel.name, Path(parent_dir).resolve() / kernel.source.name,
            argtypes), {}))
    for _, k, _ in found[1:]:
        build.KERNELS.remove(k)
    return found


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k1", action="append", default=[],
                    help="NAME=CONST:VALUE[,...]")
    ap.add_argument("--k2", action="append", default=[],
                    help="NAME=CONST:VALUE[,...] (band_rows:N, source:PATH)")
    ap.add_argument("--parent-csrc", default=None,
                    help="directory holding an earlier tree's K1/K2 sources")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("preprocess_variants: no CUDA card", file=sys.stderr)
        return 2
    from mmlspark_tpu_torch import kernels
    from mmlspark_tpu_torch.kernels import build
    from mmlspark_tpu_torch.ops import preprocess as tpre

    k1s = _kernels(kernels.FUSED_NORMALIZE, args.k1, args.parent_csrc,
                   kernels.FUSED_NORMALIZE.argtypes)
    k2s = _kernels(kernels.CROP_RESIZE_NORMALIZE, args.k2, args.parent_csrc,
                   kernels.CROP_RESIZE_NORMALIZE.argtypes)
    build.build_all([k for _, k, _ in k1s + k2s])
    for label, group in (("k1", k1s), ("k2", k2s)):
        for name, k, _ in group:
            report = build.ptxas_report(k.build_log)
            cs._line(kernel=label, variant=name,
                     ptxas=dict(zip(build.demangle(list(report)),
                                    report.values())))
    card = torch.device("cuda", 0)
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}

    k1_inputs = {}
    for shape_name, shape, dt in K1_SHAPES:
        u8 = torch.from_numpy(np.random.default_rng(3).integers(
            0, 256, shape, dtype=np.uint8)).to(card)
        consts = (torch.tensor(cs.CIFAR_MEAN, dtype=torch.float32,
                               device=card),
                  torch.from_numpy(tpre._inv_std(cs.CIFAR_STD)).to(card))
        k1_inputs[shape_name] = (u8, consts, dtypes[dt])
    raw = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (cs.BATCH, cs.SRC, cs.SRC, 3), dtype=np.uint8)).to(card)

    def k1_call(kernel, shape_name):
        u8, consts, dt = k1_inputs[shape_name]
        tpre.FUSED_NORMALIZE = kernel
        return lambda: tpre.fused_normalize(u8, *consts, dt)

    def k2_call(name, kernel, settings, dt):
        tpre.K2_BAND_ROWS = int(settings.get("band_rows",
                                             default_band_rows))
        plan = tpre.CropResizePlan((cs.SRC, cs.SRC, 3), resize=(cs.DST,) * 2,
                                   mean=cs.IMAGENET_MEAN, std=cs.IMAGENET_STD)
        tpre.K2_BAND_ROWS = default_band_rows
        if name != "parent":
            tpre.CROP_RESIZE_NORMALIZE = kernel
            return plan, lambda: tpre.crop_resize_normalize(raw, plan, dt)
        consts = plan.on(card)[:8]
        fn = kernel.symbol(kernel.name, PARENT_K2_ARGTYPES)

        def parent():
            out = torch.empty((cs.BATCH, cs.DST, cs.DST, 3), dtype=dt,
                              device=card)
            fn(raw.data_ptr(), out.data_ptr(),
               *(t.data_ptr() for t in consts), cs.BATCH, cs.SRC, cs.SRC,
               cs.DST, cs.DST, 3, int(dt == torch.bfloat16),
               torch.cuda.current_stream().cuda_stream)
            return out
        return plan, parent

    default_band_rows = tpre.K2_BAND_ROWS
    committed = (tpre.FUSED_NORMALIZE, tpre.CROP_RESIZE_NORMALIZE)
    try:
        for rnd, order in enumerate((1, -1)):
            for name, kernel, _ in k1s[::order]:
                for shape_name, shape, _ in K1_SHAPES:
                    fn = k1_call(kernel, shape_name)
                    u8, consts, dt = k1_inputs[shape_name]
                    got = fn()
                    want = tpre._fused_normalize_plain(u8, *consts, dt)
                    torch.cuda.synchronize()
                    cs._check(bool(torch.equal(got, want)),
                              f"K1 {name} {shape_name}: not bit-equal")
                    cs._line(round=rnd, kernel="k1", variant=name,
                             shape=shape_name, ms=cs._graph_ms(torch, fn))
            for name, kernel, settings in k2s[::order]:
                for shape_name, dt in K2_SHAPES:
                    dt = dtypes[dt]
                    plan, fn = k2_call(name, kernel, settings, dt)
                    got = fn()
                    want = tpre._crop_resize_normalize_plain(raw, plan, dt)
                    torch.cuda.synchronize()
                    diff = (got.float() - want.float()).abs()
                    tol = 1.01 / min(cs.IMAGENET_STD)
                    if dt == torch.bfloat16:
                        tol += 2 ** -7 * want.float().abs().max().item()
                    share = (diff > 0).float().mean().item()
                    cs._check(diff.max().item() <= tol and share <= 0.01,
                              f"K2 {name} {shape_name}: max err "
                              f"{diff.max().item()}, share {share}")
                    cs._line(round=rnd, kernel="k2", variant=name,
                             shape=shape_name, band_rows=plan.band_rows,
                             share_differing=share,
                             ms=cs._graph_ms(torch, fn))
    finally:
        tpre.FUSED_NORMALIZE, tpre.CROP_RESIZE_NORMALIZE = committed
    print(cs._smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
