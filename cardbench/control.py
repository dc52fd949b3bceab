"""Readings that the limits of ``correct`` are set from, for one cell, in
one process (set-up is paid once):

    python3 cardbench/control.py --workload <cell> --program-seeds 1,2,... \
        --control-seeds 7,8,9 --seconds 3

For each program seed, a run of the cell with a short window; for each
control seed, the same run with the control in the program's place: the
reference in float8 operands judged against the float32 reference by the
cell's own comparison, which has to read ``correct`` false. Each prints
the numbers it compares (on its ranks, for a cell on several cards). For
each control seed a lane with planted faults (``faults``: training) also
prints their readings, in this process alone. The benchmark's own runs
never run this.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != _HERE]
sys.path.insert(0, str(_HERE.parent))

CONTROL = "fp8"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    from cardbench.harness import (
        Cell, Context, lane_module, rank, run_cell, start_ranks,
    )
    cell = Cell(args.workload)
    runs = [(int(s), None) for s in args.program_seeds.split(",") if s] + \
        [(int(s), CONTROL) for s in args.control_seeds.split(",") if s]
    if runs and cell.chips > 1 and "LOCAL_WORLD_SIZE" not in os.environ:
        start_ranks(__file__, cell.chips, sys.argv[1:] if argv is None else argv)
    from mmlspark_tpu_torch.utils import config
    for seed, stand_in in runs:
        r = run_cell(args.workload, seed, args.seconds, False,
                     time.perf_counter(), cell=cell, stand_in=stand_in)
        if r is not None:
            key = "control_seed" if stand_in else "program_seed"
            print(json.dumps({key: seed, "correct": r["correct"],
                              "compared": r["compared"],
                              "metrics": r["metrics"]}), flush=True)
    lane = lane_module(cell.traffic)
    if rank() != 0 or not hasattr(lane, "faults"):
        return 0
    for seed, stand_in in runs:
        if stand_in:
            ctx = Context(cell, seed, args.seconds, False,
                          config.resolve_device(), T_PROCESS)
            print(json.dumps({"fault_seed": seed,
                              "readings": lane.faults(ctx)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
