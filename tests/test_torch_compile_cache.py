"""The port's compile seam (``mmlspark_tpu_torch/compile_cache.py``) against
the JAX package's.

The keys are the reference's pure hashing and must give its strings for
the same arguments. The port's programs (CUDA graphs; the eager function
on the CPU) cannot be serialized, so every build takes the reference's
bypass branch: one ``bypass`` per program, a ``compile_cache.bypass``
event that says why, and no file, whether ``runtime.compile_cache_dir`` is
unset or set (set, there is never an entry to load, so a ``miss`` is
counted too).
"""
import json
import os

import numpy as np
import pytest

from mmlspark_tpu import compile_cache as jcc
from mmlspark_tpu_torch import compile_cache as tcc
from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.observability import events, metrics
from mmlspark_tpu_torch.serve import Server
from mmlspark_tpu_torch.utils import config as tconfig


@pytest.fixture(autouse=True)
def _cpu():
    tconfig.set("runtime.device", "cpu")
    metrics.get_registry().reset()
    yield
    tconfig.unset("runtime.device")
    tconfig.unset("runtime.compile_cache_dir")
    metrics.get_registry().reset()


def _model():
    m = TorchModel(inputCol="x", outputCol="y", miniBatchSize=8)
    return m.set_model("mlp_tabular", input_dim=8, hidden=[16],
                       num_classes=3, seed=0)


@pytest.mark.parametrize("args", [
    ("mlp", "v1", 8, (8,), "float32", ""),
    ("resnet", "v2", 64, (256 * 256 * 3,), "uint8", ""),
    ("lm", "v1", 1, (2048,), "int32", "data=4,tensor=2"),
    ("m", "", 0, (), "float64", ""),
])
def test_entry_key_equals_the_reference(args):
    assert tcc.entry_key(*args) == jcc.entry_key(*args)


@pytest.mark.parametrize("args", [
    ("lm", "v1", "prefill", "prefill:1024|arena=129x16x8x64"),
    ("lm", "v1", "decode", "decode:8|W=128|dtype=bfloat16"),
    ("tiny", "v3", "cow", ""),
])
def test_program_key_equals_the_reference(args):
    assert tcc.program_key(*args) == jcc.program_key(*args)


def test_stats_have_the_reference_keys():
    assert set(tcc.stats()) == set(jcc.stats())


@pytest.mark.parametrize("cache_dir", [False, True])
def test_every_build_bypasses_and_writes_no_file(tmp_path, cache_dir):
    root = tmp_path / "cache"
    if cache_dir:
        tconfig.set("runtime.compile_cache_dir", str(root))
    path = tmp_path / "events.jsonl"
    tconfig.set("observability.events_path", str(path))
    try:
        rng = np.random.default_rng(0)
        with Server({"mlp": _model()}, max_batch=8, max_wait_ms=1.0,
                    buckets=(1, 4, 8)) as srv:
            for rows in (1, 3, 8, 2, 1, 7):
                srv.submit("mlp", rng.normal(size=(rows, 8)), timeout=30)
            builds = srv.stats()["registry.compiles"]
    finally:
        events.close()
        tconfig.unset("observability.events_path")
    assert builds == 3
    st = tcc.stats()
    assert st["bypasses"] == builds
    assert st["misses"] == (builds if cache_dir else 0)
    assert st["hits"] == st["stores"] == 0
    assert not root.exists() or os.listdir(root) == []
    bypass = [json.loads(ln) for ln in path.read_text().splitlines()
              if '"bypass"' in ln]
    assert len(bypass) == builds
    reason = bypass[0]["reason"]
    assert ("not serializable" in reason) if cache_dir \
        else (reason == "runtime.compile_cache_dir unset")
    assert tcc.enable_from_config() == (str(root) if cache_dir else None)


def test_cache_dir_and_worker_env(tmp_path):
    assert tcc.cache_dir() == "" and tcc.worker_env() == {}
    tconfig.set("runtime.compile_cache_dir", str(tmp_path))
    assert tcc.cache_dir() == str(tmp_path)
    assert tcc.worker_env() == {
        "MMLSPARK_TPU_TORCH_RUNTIME_COMPILE_CACHE_DIR": str(tmp_path)}


def test_fingerprint_names_torch_and_the_device():
    import torch
    fp = tcc.device_fingerprint()
    assert f"torch={torch.__version__}" in fp
    assert "device=" in fp


def test_a_failing_build_raises_and_counts_no_bypass():
    def fresh():
        raise RuntimeError("capture failed")
    with pytest.raises(RuntimeError, match="capture failed"):
        tcc.load_or_compile("m", "v1", 8, (4,), np.float32, fresh)
    assert tcc.stats()["bypasses"] == 0
