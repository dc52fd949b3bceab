"""One run of one benchmark cell; the last line of standard output is the
result. From the root of a checkout::

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell on several cards starts one rank a card through the port's own
launcher (``python -m mmlspark_tpu_torch.cli run --nprocs N``), which
waits for them; rank 0 prints the result. Exits non-zero, and prints no
result, without the CUDA cards the cell asks for, without the port's
package beside ``cardbench/``, or when JAX or the JAX package was
loaded."""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root, not this directory, is where imports resolve
_HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != _HERE]
sys.path.insert(0, str(_HERE.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from cardbench.harness import (
        CellError, banned_modules, chips, run_cell, start_ranks,
    )
    # the process start, on the wall clock, that set-up is timed from: a
    # rank inherits its launcher's
    t0_wall = float(os.environ.get(
        "CARDBENCH_T0", time.time() - (time.perf_counter() - T_PROCESS)))
    n = chips(args.workload)
    if n > 1 and "LOCAL_WORLD_SIZE" not in os.environ:
        os.environ["CARDBENCH_T0"] = repr(t0_wall)
        start_ranks(__file__, n, sys.argv[1:] if argv is None else argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace),
                          time.perf_counter() - (time.time() - t0_wall))
    except CellError as e:
        print(f"cardbench: {e}", file=sys.stderr)
        return 2
    except Exception:
        traceback.print_exc()
        return 1
    if result is None:      # a rank other than 0
        return 0
    if banned_modules():
        print(f"cardbench: JAX or the JAX package is loaded: "
              f"{banned_modules()}", file=sys.stderr)
        return 2
    print(json.dumps({k: v for k, v in result["info"].items()}),
          file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
