#!/usr/bin/env python3
"""Time tile variants of K3's CUDA-core kernel on one card, in turns.

    python3 k3_variants.py --variant d64_bq128=64:128,16,16,64,1 \
                           --variant d512_bq16=512:16,4,32,128,1

A variant is ``mmlspark_tpu_torch/kernels/csrc/flash_attention.cu`` with
some of its ``K3_CONFIG`` lines replaced: ``NAME=DPAD:BQ,TY,TX,DC,MINB``
(padded head dim: query rows a block, thread rows, thread columns, head
dims a K/V stage, blocks an SM should hold; join several with ``;``). The
committed source runs as ``committed``. Every source is built as the
kernel itself is (nvcc, one process per source, all at once, into the
build directory), its ptxas report is printed, and each is held against
the plain version at the shapes below (f32 within 2e-5, bf16 within one
bf16 step beyond that) and timed as ``chip_smoke.py`` times kernels
(device time of CUDA-graph replays), in two rounds, the second in reverse
order. Prints one JSON line per (round, variant, shape), then the card's
name and power limit. Fails without CUDA or if a variant misses its gate.
"""
from __future__ import annotations

import argparse
import json
import re
import sys

import numpy as np

import chip_smoke as cs

# the f32 route's shapes in chip_smoke.py's kernel check, all causal
SHAPES = [("lm_f32", (8, 2048, 8, 64), "float32"),
          ("lm_d128_f32", (8, 2048, 4, 128), "float32"),
          ("d512_f32", (2, 512, 4, 512), "float32"),
          ("d256_bf16", (2, 2048, 4, 256), "bfloat16")]


def variant_source(source: str, spec: str) -> str:
    """``source`` with the K3_CONFIG line of each ``DPAD:BQ,TY,TX,DC,MINB``
    in ``spec`` (``;``-separated) replaced."""
    for part in spec.split(";"):
        dpad, fields = part.split(":")
        line = re.compile(rf"K3_CONFIG\({int(dpad)}, [^)]*\)")
        if not line.search(source):
            raise ValueError(f"no K3_CONFIG line for D = {dpad}")
        source = line.sub(f"K3_CONFIG({int(dpad)}, "
                          + ", ".join(f.strip() for f in fields.split(","))
                          + ")", source)
    return source


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=DPAD:BQ,TY,TX,DC,MINB[;DPAD:...]")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k3_variants: no CUDA card", file=sys.stderr)
        return 2
    from mmlspark_tpu_torch.kernels import _K3_ARGTYPES, FLASH_ATTENTION, build
    from mmlspark_tpu_torch.ops import attention as tatt
    torch.backends.cuda.matmul.allow_tf32 = False

    committed = FLASH_ATTENTION.source.read_text()
    sources = {"committed": committed}
    for v in args.variant:
        name, spec = v.split("=", 1)
        sources[name] = variant_source(committed, spec)
    kernels = {}
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name, text in sources.items():
        k = build.Kernel("flash_attention", "flash_attention.cu",
                         _K3_ARGTYPES)
        build.KERNELS.remove(k)
        if name != "committed":
            k.source = build.BUILD_DIR / f"flash_attention-{name}.cu"
            k.source.write_text(text)
        kernels[name] = k
    build.build_all(list(kernels.values()))
    for name, k in kernels.items():
        report = build.ptxas_report(k.build_log)
        print(json.dumps({"variant": name, "ptxas": dict(zip(
            build.demangle(list(report)), report.values()))}), flush=True)

    card = torch.device("cuda", 0)
    data = {}
    for shape_name, shape, dtype in SHAPES:
        rng = np.random.default_rng(8)
        q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                   .to(card, getattr(torch, dtype)) for _ in range(3))
        data[shape_name] = (q, k, v, tatt.flash_attention_plain(q, k, v, True))
    names = list(kernels)
    try:
        for rnd, order in enumerate((names, names[::-1])):
            for name in order:
                tatt.FLASH_ATTENTION = kernels[name]
                for shape_name, (q, k, v, want) in data.items():
                    def call():
                        return tatt.flash_attention(q, k, v, causal=True)
                    got = call()
                    err = (got.float() - want.float()).abs().max().item()
                    steps = cs._bf16_steps(got, want)
                    cs._check(err <= cs.K3_F32_TOL if q.dtype == torch.float32
                              else steps <= 1.0,
                              f"{name} {shape_name}: max err {err}, "
                              f"{steps} bf16 steps")
                    print(json.dumps({"round": rnd, "variant": name,
                                      "shape": shape_name,
                                      "ms": cs._graph_ms(torch, call),
                                      "max_abs_err": err}), flush=True)
    finally:
        tatt.FLASH_ATTENTION = FLASH_ATTENTION
    print(cs._smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
