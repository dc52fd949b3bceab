"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names, and the reference loads nothing of the
port. The JAX package's bench files are never read."""
import ast
import json
import subprocess
import sys

from cardbench.harness import BANNED, HERE, ROOT


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_the_run_and_every_module_its_lanes_load_leave_jax_out():
    port = sorted({m for f in (HERE / "lanes").glob("*.py")
                   for m in _imports(f) if m.startswith("mmlspark_tpu_torch")})
    readers = sorted(str(f) for f in (HERE / "metrics").glob("*.py")
                     if f.name != "__init__.py")
    code = f"""
import importlib, json, runpy, sys
sys.argv = ["run.py", "--help"]
try:
    runpy.run_path({str(HERE / 'run.py')!r}, run_name="__main__")
except SystemExit:
    pass
from cardbench import harness
for lane in ("featurize", "serve", "train"):
    importlib.import_module("cardbench.lanes." + lane)
for name in {port!r}:
    importlib.import_module(name)
for path in {readers!r}:
    harness.reader(path.rsplit("/", 1)[1][:-3])
import cardbench.control, cardbench.sweep
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    loaded = set(json.loads(done.stdout.strip().splitlines()[-1]))
    assert "mmlspark_tpu_torch" in loaded
    assert not loaded & set(BANNED), loaded & set(BANNED)


def test_the_yardstick_imports_nothing_of_the_port():
    for sub in ("reference", "counts"):
        for f in (HERE / sub).glob("*.py"):
            for m in _imports(f):
                top = m.split(".", 1)[0]
                assert top not in BANNED + ("mmlspark_tpu_torch",), (f, m)
    for f in (HERE / "metrics").glob("*.py"):
        for m in _imports(f):
            assert m.split(".", 1)[0] not in BANNED + ("mmlspark_tpu_torch",)


def test_no_file_reads_the_jax_bench():
    for f in HERE.rglob("*.py"):
        if f.parent.name == "tests":
            continue
        text = f.read_text()
        for name in ("bench.py", "BENCH_r", "BASELINE.json",
                     "benchmark_metrics.json"):
            assert name not in text, (f, name)
