"""The knee of a serving cell: its traffic at each offered rate in turn, in
one process, one line each (p50/p95, the generator's lateness, answers per
second, how long after the window's close the last answer came):

    python3 cardbench/sweep.py --workload resnet50.serve \
        --rates 800,1200,1600 --seconds 8

The knee is the highest rate at which answers keep pace with arrivals and
neither the lateness nor the last answer's delay grows; the cell runs at
four fifths of it. The benchmark's own runs never run this."""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != _HERE]
sys.path.insert(0, str(_HERE.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    from cardbench.harness import Cell, run_cell
    for rate in [float(r) for r in args.rates.split(",")]:
        cell = Cell(args.workload)
        cell.traffic["phases"] = [[1.0, rate]]
        r = run_cell(args.workload, args.seed, args.seconds, False,
                     time.perf_counter(), cell=cell)
        print(json.dumps({"rate": rate, "correct": r["correct"],
                          "failed": r["failed"], "metrics": r["metrics"],
                          "info": r["info"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
