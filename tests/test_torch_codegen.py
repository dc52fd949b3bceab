"""The port's codegen: ``docs/API_TORCH.md`` is fresh, the generated
per-stage suite covers (and passes on) every stage the port registers, and
every stage the JAX package registers has a port counterpart by class name
(``JaxModel`` <-> ``TorchModel``)."""
import os

import pytest

from mmlspark_tpu.codegen.generate import all_stages as jax_stages
from mmlspark_tpu_torch.codegen.generate import (
    all_stages, generate_api_reference, generate_stage_test_source,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RENAMED = {"JaxModel": "TorchModel"}


def test_api_reference_is_fresh():
    path = os.path.join(REPO, "docs", "API_TORCH.md")
    assert os.path.exists(path), "docs/API_TORCH.md missing: run " \
        "`python -m mmlspark_tpu_torch.codegen.generate docs/API_TORCH.md`"
    with open(path) as f:
        on_disk = f.read()
    assert on_disk == generate_api_reference(), (
        "docs/API_TORCH.md is stale: run "
        "`python -m mmlspark_tpu_torch.codegen.generate docs/API_TORCH.md`")


def test_api_reference_mentions_every_stage():
    ref = generate_api_reference()
    for qualname in all_stages():
        name = qualname.rsplit(".", 1)[1]
        assert f"### {name} (" in ref, f"{name} missing from API reference"


def test_every_jax_stage_has_a_port_counterpart():
    """By class name, in the same module path; none missing."""
    port = {q.replace("mmlspark_tpu_torch.", "", 1) for q in all_stages()}
    missing = []
    for q in jax_stages():
        module, name = q.replace("mmlspark_tpu.", "", 1).rsplit(".", 1)
        module = module.replace("jax_model", "torch_model")
        if f"{module}.{RENAMED.get(name, name)}" not in port:
            missing.append(q)
    assert missing == []
    assert len(port) == len(jax_stages())


def _generated_namespace():
    src = generate_stage_test_source()
    ns = {}
    exec(compile(src, "<generated_stage_tests>", "exec"), ns)
    return ns


def test_generated_suite_covers_every_stage():
    ns = _generated_namespace()
    tests = [k for k in ns if k.startswith("test_generated_")]
    assert len(tests) == len(all_stages())
    assert "mmlspark_tpu." not in generate_stage_test_source()


@pytest.mark.parametrize("name", sorted(
    k for k in _generated_namespace() if k.startswith("test_generated_")))
def test_generated(name):
    """Run each generated per-stage smoke test."""
    ns = _generated_namespace()
    ns[name]()
