"""Runs one cell: resolves its files by name, checks the device, runs its
lane, reads its per-layer metrics and assembles the result line.

Everything that belongs to one cell is data: ``BENCHMARK.json`` names the
cell's configuration and traffic; ``configs/<config>.json``,
``traffic/<traffic>.json`` (which names its lane, ``lanes/<lane>.py``) and
``limits/<cell>.json`` hold its numbers; ``metrics/<metric>.py``, or else
``metrics/<part before the first dot>.py``, reads each per-layer metric,
in the cells its ``workloads`` list.

A configuration names its architecture's family by ``family`` (its
``architecture`` where it has none), and a family brings two files of its
own: ``reference/<family>.py``, the plain reference (``param_specs`` and
``forward``), and ``counts/<family>.py``, whose ``forward(cfg,
image_size)`` counts the FLOPs of one image. A ``param_specs`` entry may
carry a fourth element, the fan-in of a banked weight such as an ``(E, D,
H)`` expert bank; a configuration's ``aux_loss_weight`` adds that weight
times the model's auxiliary loss to the training loss of both sides. So a
new architecture enters by new files and entries alone."""
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "mmlspark_tpu")


class CellError(RuntimeError):
    """A run that cannot give a result: it prints none and exits non-zero."""


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def family_module(kind: str, cfg: Dict):
    """``cardbench.<kind>.<family>``: the module of ``cfg``'s architecture
    family under ``reference/`` or ``counts/``."""
    family = cfg.get("family", cfg["architecture"])
    name = f"cardbench.{kind}.{family}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise CellError(f"configuration {cfg['name']!r} names family "
                        f"{family!r}, and cardbench/{kind}/{family}.py "
                        f"does not exist") from None


class Cell:
    """One workload of ``BENCHMARK.json`` with its files loaded."""

    def __init__(self, name: str):
        bench = benchmark()
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise CellError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = found[0]
        self.name = name
        self.chips = int(self.entry["chips"])
        conf = [c for c in bench["configs"] if c["name"] == self.entry["config"]]
        if not conf:
            raise CellError(f"no configuration {self.entry['config']!r}")
        self.cfg = load_json(ROOT / conf[0]["file"])
        self.traffic = load_json(HERE / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = load_json(HERE / "limits" / f"{name}.json")
        self.e2e = [m for m in bench["end_to_end"]
                    if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m["workloads"]]


def chips(name: str) -> int:
    """The cards a cell asks for."""
    return int(Cell(name).chips)


def start_ranks(script: str, n: int, argv) -> None:
    """Replace this process by the port's launcher running ``script`` with
    ``argv`` on ``n`` ranks, one a card (``cli run --nprocs n``), which
    waits for them all."""
    os.execv(sys.executable, [
        sys.executable, "-m", "mmlspark_tpu_torch.cli", "run",
        os.path.relpath(script), "--nprocs", str(n), "--platform", "cuda",
        "--", *argv])


def rank() -> int:
    """This process's rank in the joined process group (0 outside one)."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def lane_module(traffic: Dict):
    return importlib.import_module(f"cardbench.lanes.{traffic['lane']}")


def reader(metric: str):
    """The reader of per-layer metric ``metric``: ``metrics/<metric>.py``,
    else ``metrics/<part before the first dot>.py``."""
    for stem in (metric, metric.split(".", 1)[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"cardbench_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise CellError(f"no reader for per-layer metric {metric!r}")


def banned_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(BANNED))


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        done = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return done.stdout.strip().splitlines()[0] if done.returncode == 0 \
        and done.stdout.strip() else None


class Context:
    """What a lane gets: the cell's numbers, the seed, the window's length,
    the tracer, the clock that ``setup_s`` is read from, and ``stand_in``:
    None, or the reference's precision ("fp8") whose answers the lane puts
    in the place of the program's before it compares (the control)."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, t_process: float, stand_in: Optional[str] = None):
        from cardbench.tracing import Tracer
        self.cell, self.cfg, self.traffic = cell, cell.cfg, cell.traffic
        self.limits = cell.limits
        self.seed, self.seconds, self.trace = int(seed), float(seconds), trace
        self.device = device
        self.stand_in = stand_in
        self.t_process = t_process
        self.tracer = Tracer(trace)
        self.setup_s = None
        self.setup_split = {}
        self._marks = [("imports", time.perf_counter())]

    def mark(self, phase: str) -> None:
        """End set-up phase ``phase`` (weights, inputs, model, warm-up):
        its seconds go into the result's ``info``."""
        self._marks.append((phase, time.perf_counter()))

    def window_opens(self) -> float:
        """Mark the start of the first timed unit of work: the end of
        set-up. Returns the host clock."""
        now = time.perf_counter()
        self.setup_s = now - self.t_process
        prev = self.t_process
        for phase, t in self._marks:
            self.setup_split[phase] = t - prev
            prev = t
        self.setup_split["rest"] = now - prev
        return now


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_process: float, device: str = "cuda",
             cell: Optional[Cell] = None,
             stand_in: Optional[str] = None) -> Optional[Dict]:
    """One run of a cell: the result line as a dict, on rank 0 (None on
    the other ranks of a cell on several cards). ``device="cuda"`` needs
    the cards the cell asks for; the tests pass ``"cpu"`` (and a small
    ``cell``) to drive the rest of a run without one. ``stand_in`` runs
    the control: the reference in that precision judged in the program's
    place (``control.py`` and the tests; never the benchmark's runs)."""
    import torch

    import mmlspark_tpu_torch  # noqa: F401  (the system under test)
    cell = cell or Cell(name)
    if device == "cuda":
        if not torch.cuda.is_available():
            raise CellError("no CUDA device: torch.cuda.is_available() is False")
        if torch.cuda.device_count() < cell.chips:
            raise CellError(f"{cell.name} needs {cell.chips} cards, "
                            f"{torch.cuda.device_count()} visible")
    from mmlspark_tpu_torch.utils import config
    if device != "cuda":
        config.set("runtime.device", device)
    ctx = Context(cell, seed, seconds, trace, config.resolve_device(),
                  t_process, stand_in)
    lane = lane_module(cell.traffic)
    out = lane.run(ctx)
    found = banned_modules()
    if found:
        raise CellError(f"JAX or the JAX package is loaded: {found}")
    if out is None:
        return None
    metrics = {}
    if trace:
        rec = out["record"]
        if rec is None:
            raise CellError("the window closed before its traced stretch began")
        rec.update(cfg=cell.cfg, traffic=cell.traffic, chips=cell.chips)
        for m in cell.per_layer:
            value = reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=ctx.setup_s)
        for m in cell.e2e:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": torch.cuda.get_device_name(0) if device == "cuda"
                   else device,
                   "count": cell.chips,
                   "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": bool(out["correct"]),
              "attempted": int(out["attempted"]),
              "failed": int(out["failed"]),
              "metrics": metrics, "device": device_info}
    if trace:
        from cardbench.tracing import device_ops_top, idle_gaps_top
        rec = out["record"]
        device_info["busy_s"] = sum(rec["busy_s"]) / len(rec["busy_s"])
        device_info["window_s"] = rec["window_s"]
        result["breakdown"] = {"device_ops": device_ops_top(rec),
                               "idle_gaps": idle_gaps_top(rec)}
        out.setdefault("info", {})["trace_ops_in_window"] = rec["ops_in_window"]
    result["info"] = dict(out.get("info", {}), seed=int(seed),
                          setup_split=ctx.setup_split,
                          seconds=seconds, card=power_limit()
                          if device == "cuda" else None)
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in out["compared"].items()}
    return result


def free_device() -> None:
    """Collect and return cached device memory, so the reference that
    follows neither sees the program's state nor sets the peak."""
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def within(value: float, limit: float) -> bool:
    return math.isfinite(value) and value <= limit
