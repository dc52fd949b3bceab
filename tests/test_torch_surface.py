"""The last functions of the JAX package's public surface, in the port,
against the JAX package's behaviour on the same inputs:
``events.events_path``, ``faults.active_plan``, ``Gauge.inc``,
``MetricsRegistry.to_json``, ``MetricTable.to_frame``, ``set_level`` and
``DistributedTrainer.abstract_state``.

``abstract_state`` has no JAX counterpart to compare values with (the
reference's returns ``jax.ShapeDtypeStruct``s and ``NamedSharding``s):
its shapes and dtypes are held to ``init``'s leaves and to the optimizer
state of a real step, its tensors must be on the meta device, and on a
2-rank gloo mesh (``tests/torch_mesh_ranks.py::abstract_layouts``) every
layout must equal the meshed trainer's placement. A last test reads both
packages' sources and requires every public function, class and method
of each JAX-package file in its port file. Everything here is exact: no
tolerance.
"""
import ast
import json
import logging
import os

import numpy as np
import pytest
import torch

from mmlspark_tpu.core import metrics as jcore_metrics
from mmlspark_tpu.observability import events as jevents
from mmlspark_tpu.observability import metrics as jmetrics
from mmlspark_tpu.reliability import faults as jfaults
from mmlspark_tpu.utils import config as jconfig
from mmlspark_tpu.utils import logging as jlogging
from mmlspark_tpu_torch.core import metrics as tcore_metrics
from mmlspark_tpu_torch.models.zoo import build_model, init_state
from mmlspark_tpu_torch.observability import events as tevents
from mmlspark_tpu_torch.observability import metrics as tmetrics
from mmlspark_tpu_torch.parallel import optim
from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer
from mmlspark_tpu_torch.reliability import faults as tfaults
from mmlspark_tpu_torch.testing.ranks import RankPool
from mmlspark_tpu_torch.utils import config as tconfig
from mmlspark_tpu_torch.utils import logging as tlogging

import torch_mesh_ranks as R

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
# JAX-package files whose port has another name
PORT_FILES = {"ops/pallas_attention.py": "ops/attention.py",
              "ops/pallas_preprocess.py": "ops/preprocess.py",
              "models/jax_model.py": "models/torch_model.py"}
# no counterpart by design: a shim that finds shard_map wherever the
# installed JAX version keeps it; the port's meshes are torch.distributed
# process groups (ROADMAP.md)
NO_COUNTERPART = {("parallel/sharding.py", "shard_map_compat")}


@pytest.fixture(autouse=True)
def on_cpu():
    tconfig.set("runtime.device", "cpu")
    yield
    tconfig.unset("runtime.device")


@pytest.mark.parametrize("path", ["", "events.jsonl"])
def test_events_path_reads_the_config_as_the_reference(tmp_path, path):
    value = str(tmp_path / path) if path else ""
    for config, events in ((tconfig, tevents), (jconfig, jevents)):
        config.set("observability.events_path", value)
    try:
        assert tevents.events_path() == jevents.events_path() == value
    finally:
        tconfig.unset("observability.events_path")
        jconfig.unset("observability.events_path")


def test_active_plan_is_the_installed_plan_as_in_the_reference():
    assert tfaults.active_plan() is None and jfaults.active_plan() is None
    with tfaults.FaultPlan() as tplan, jfaults.FaultPlan() as jplan:
        assert tfaults.active_plan() is tplan
        assert jfaults.active_plan() is jplan
    assert tfaults.active_plan() is None and jfaults.active_plan() is None


@pytest.mark.parametrize("steps", [[], [1.0], [2.5, -0.5, 1e9]])
def test_gauge_inc_adds_as_the_reference(steps):
    got, want = tmetrics.Gauge("g"), jmetrics.Gauge("g")
    for g in (got, want):
        g.set(3)
        g.inc()
        for n in steps:
            g.inc(n)
    assert got.value == want.value == 4.0 + sum(steps)


def _fill(registry):
    registry.counter("req.total").inc(3)
    registry.gauge("queue.depth").set(7)
    registry.gauge("queue.depth").inc(-2)
    h = registry.histogram("latency_ms", buckets=(1.0, 10.0, 100.0))
    for v in (0.5, 5.0, 50.0, 500.0):
        h.observe(v)
    registry.histogram("ttft_ms").observe(12.5, exemplar="trace-1")
    return registry


def test_registry_to_json_equals_the_reference():
    got = _fill(tmetrics.MetricsRegistry()).to_json()
    want = _fill(jmetrics.MetricsRegistry()).to_json()
    assert got == want
    assert json.loads(got)["queue.depth"] == {"type": "gauge", "value": 5.0}


def test_metric_table_to_frame_equals_the_reference():
    rows = np.array([[0.0, 3.0], [1.0, 5.0], [2.0, 8.0]])
    got = tcore_metrics.create_table("cm", ["a", "b"], rows).to_frame()
    want = jcore_metrics.create_table("cm", ["a", "b"], rows).to_frame()
    assert got.columns == want.columns == ["a", "b"]
    for c in ("a", "b"):
        np.testing.assert_array_equal(got.column(c), want.column(c))
        assert got.column(c).dtype == want.column(c).dtype


@pytest.mark.parametrize("level", ["DEBUG", "WARNING"])
def test_set_level_sets_the_config_and_the_root_logger(level):
    before = (tconfig.get("logging.level"), jconfig.get("logging.level"))
    try:
        tlogging.set_level(level)
        jlogging.set_level(level)
        assert tconfig.get("logging.level") == jconfig.get(
            "logging.level") == level
        assert logging.getLogger("mmlspark_tpu_torch").level \
            == logging.getLogger("mmlspark_tpu").level \
            == logging.getLevelName(level)
    finally:
        tlogging.set_level(before[0])
        jlogging.set_level(before[1])
        tconfig.unset("logging.level")
        jconfig.unset("logging.level")


def _ce_loss(module, batch, gen):
    return torch.nn.functional.cross_entropy(module(batch["x"]),
                                             batch["y"].long())


@pytest.mark.parametrize("opt", ["adam", "sgd", "lamb", "adafactor"])
def test_abstract_state_shapes_match_init_and_a_step(opt):
    arch = dict(input_dim=6, hidden=[16], num_classes=3, dtype="float32")

    def init_fn():
        return build_model("mlp_tabular", **arch)["module"]

    trainer = DistributedTrainer(_ce_loss, R._optimizer(opt, 1e-2))
    abstract, shardings = trainer.abstract_state(init_fn)
    assert shardings is None and trainer.state_sharding_spec() is None
    leaves = [*abstract["params"].values(), abstract["step"],
              *(t for st in abstract["opt_state"].values()
                for t in st.values())]
    assert all(t.device.type == "meta" for t in leaves)

    state = trainer.init(init_fn)
    assert {n: (tuple(p.shape), p.dtype) for n, p in
            state["module"].named_parameters()} == {
        n: (tuple(t.shape), t.dtype) for n, t in abstract["params"].items()}
    assert (state["step"].shape, state["step"].dtype) == (
        abstract["step"].shape, abstract["step"].dtype)
    rng = np.random.default_rng(0)
    batch = {"x": rng.normal(size=(8, 6)).astype(np.float32),
             "y": rng.integers(0, 3, 8).astype(np.int32)}
    trainer.train_step(state, trainer.put_batch(batch), 0)
    opt_state = state["optimizer"].torch.state
    got = {n: {k: (tuple(v.shape), v.dtype)
               for k, v in opt_state[p].items() if torch.is_tensor(v)}
           for n, p in state["module"].named_parameters()}
    want = {n: {k: (tuple(t.shape), t.dtype) for k, t in st.items()}
            for n, st in abstract["opt_state"].items()}
    assert got == want


def test_abstract_state_allocates_no_parameter():
    """A ResNet-50's state (25.6M parameters, adam: 3x that) costs
    nothing: every tensor is on the meta device, none has storage."""
    trainer = DistributedTrainer(_ce_loss, optim.adam(1e-3))
    abstract, _ = trainer.abstract_state(
        lambda: build_model("resnet50", num_classes=1000)["module"])
    tensors = [*abstract["params"].values(),
               *(t for st in abstract["opt_state"].values()
                 for t in st.values())]
    assert sum(t.numel() for t in abstract["params"].values()) > 25_000_000
    assert all(t.is_meta for t in tensors)


@pytest.fixture(scope="module")
def pool():
    with RankPool(2, paths=[TESTS, REPO]) as p:
        yield p


@pytest.mark.parametrize("opt,axes", [("adam", {"tensor": 2}),
                                      ("adafactor", {"data": 2})])
def test_abstract_state_layouts_match_the_meshed_placement(pool, opt, axes):
    params = init_state(R._lm_module(), seed=0)
    out = pool.run("torch_mesh_ranks:abstract_layouts", axes, params, opt)
    for rank in out:
        assert rank["all_meta"]
        assert rank["params_mismatch"] == [], rank["params_mismatch"]
        assert rank["opt_mismatch"] == [], rank["opt_mismatch"]
        assert rank["sharded"] > 0 or "data" in axes


def _public(path):
    """Top-level public functions and classes of a file, and each public
    class's public methods (``Class.method``)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and not node.name.startswith("_"):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out.update(f"{node.name}.{m.name}" for m in node.body
                           if isinstance(m, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))
                           and not m.name.startswith("_"))
    return out


def _ported_name(name):
    return name.replace("Jax", "Torch").replace("jax", "torch")


def test_every_public_symbol_of_the_jax_package_has_its_port():
    """Every public function, class and method of each JAX-package file
    is in its port file, under the same name or with ``Jax`` -> ``Torch``
    (``to_jax_model`` -> ``to_torch_model``)."""
    ref_root = os.path.join(REPO, "mmlspark_tpu")
    port_root = os.path.join(REPO, "mmlspark_tpu_torch")
    missing, files = [], 0
    for root, _, names in os.walk(ref_root):
        for fname in sorted(names):
            if not fname.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(root, fname), ref_root)
            port = os.path.join(port_root, PORT_FILES.get(rel, rel))
            assert os.path.exists(port), f"{rel} has no port file"
            files += 1
            have = _public(port)
            for name in sorted(_public(os.path.join(root, fname))):
                if name not in have and _ported_name(name) not in have \
                        and (rel, name) not in NO_COUNTERPART:
                    missing.append(f"{rel}::{name}")
    assert files > 100
    assert missing == []
