"""One rank of a cell on several ranks, driven on the CPU at a small size
(run under ``python -m mmlspark_tpu_torch.cli run --nprocs N --platform
cpu`` with gloo); rank 0 prints the result line. ``--fault exchange``
leaves the gradient all-reduce out."""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main():
    import faulthandler
    faulthandler.dump_traceback_later(120, exit=True)
    ap = argparse.ArgumentParser()
    ap.add_argument("--fault", default="")
    ap.add_argument("--seed", type=int, default=2**31 + 3)
    args = ap.parse_args()
    from cardbench.harness import Cell, run_cell
    if args.fault == "exchange":
        from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer
        DistributedTrainer._sum_grads = lambda self, module: None
    cell = Cell("vit_b16.train_dp4")
    cell.cfg = dict(cell.cfg, image_size=32,
                    arch_args=dict(cell.cfg["arch_args"], image_size=32))
    cell.traffic = dict(cell.traffic, epoch_images=2048, warm_steps=1)
    r = run_cell(cell.name, args.seed, 1.0, False, time.perf_counter(),
                 device="cpu", cell=cell)
    if r is not None:
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
