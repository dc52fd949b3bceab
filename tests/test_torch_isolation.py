"""The PyTorch port stands alone: it loads no JAX and nothing of the JAX
package, and it never carries on on the CPU unless asked to."""
import os
import subprocess
import sys

import numpy as np
import pytest

from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.image.featurizer import ImageFeaturizer
from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.utils import config as tconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import mmlspark_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax")
             or m == "mmlspark_tpu" or m.startswith("mmlspark_tpu."))
print(len(names), bad)
"""


def test_importing_every_port_module_loads_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items()}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    # every module: serve/ and compile_cache too, the process fleet's
    # cli, control/, testing/, supervisor, launcher, slo, goodput and
    # preemption, the streamed input and resume slice's codecs, native
    # loader, data pipeline, checkpointer, resilient loop and disk, and
    # the meshed layers' mesh, sharding, collectives and rank pool, and
    # the run's record: the flight recorder, trace export and profiling
    assert int(count) >= 105
    assert bad == "[]", bad


def _port_sources():
    """Every Python source of the port, ``chip_smoke.py`` and the kernel
    variant scripts."""
    root = os.path.join(REPO, "mmlspark_tpu_torch")
    paths = [os.path.join(REPO, f) for f in ("chip_smoke.py",
                                             "k3_variants.py",
                                             "preprocess_variants.py")]
    for dirpath, _, files in os.walk(root):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return paths


def test_port_sources_name_no_jax_import():
    """No source file of the port, nor ``chip_smoke.py``, spells an import
    of JAX, flax, optax, orbax or the JAX package (a lazy import would
    escape the subprocess check above)."""
    offenders = []
    for path in _port_sources():
        with open(path) as fh:
            for i, line in enumerate(fh, 1):
                words = line.split()
                if words[:1] in (["import"], ["from"]) and len(words) > 1:
                    mod = words[1].split(".")[0].rstrip(",")
                    if mod in ("jax", "jaxlib", "flax", "optax", "orbax",
                               "mmlspark_tpu"):
                        offenders.append(f"{os.path.basename(path)}:{i}")
    assert len(_port_sources()) >= 40
    assert offenders == []


def test_chip_smoke_loads_no_jax_and_no_jax_package():
    """Importing ``chip_smoke``, the kernel variant scripts and the port
    modules they drive loads no JAX: the card's machine has none."""
    code = _IMPORT_ALL.replace(
        "import mmlspark_tpu_torch as pkg",
        "import chip_smoke\nimport k3_variants\nimport preprocess_variants\n"
        "import mmlspark_tpu_torch as pkg")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().split(" ", 1)[1] == "[]"


def test_no_port_module_calls_a_library_attention_kernel():
    """The port's attention is K3 and plain torch ops: no module of the
    package calls PyTorch's fused attention (``chip_smoke.py`` times it
    as a yardstick only)."""
    root = os.path.join(REPO, "mmlspark_tpu_torch")
    offenders = [p for p in _port_sources() if p.startswith(root)
                 and "scaled_dot_product_attention" in open(p).read()]
    assert offenders == []


@pytest.fixture
def default_device(monkeypatch):
    """runtime.device at its default, "cuda", on a machine without CUDA."""
    import torch
    monkeypatch.delenv("MMLSPARK_TPU_TORCH_RUNTIME_DEVICE", raising=False)
    tconfig.unset("runtime.device")
    if torch.cuda.is_available():
        pytest.skip("CUDA is available; the check is for a machine without it")
    assert tconfig.get("runtime.device") == "cuda"


def test_torch_model_raises_instead_of_running_on_the_cpu(default_device):
    model = TorchModel(inputCol="x", outputCol="f", miniBatchSize=2)
    model.set_model("resnet20_cifar", num_classes=3, dtype="float32")
    frame = Frame.from_dict({"x": np.zeros((2, 32 * 32 * 3), np.float32)})
    with pytest.raises(RuntimeError, match="is_available"):
        model.transform(frame)


def test_image_featurizer_raises_instead_of_running_on_the_cpu(
        default_device):
    from mmlspark_tpu_torch.core.schema import ColumnSchema, DType, ImageValue
    vals = np.empty(2, dtype=object)
    for i in range(2):
        vals[i] = ImageValue(path=None, data=np.zeros((8, 8, 3), np.uint8))
    frame = Frame.from_dict({"row": np.arange(2)}).with_column_values(
        ColumnSchema("image", DType.IMAGE), vals)
    fz = ImageFeaturizer(miniBatchSize=2)
    fz.set_model("resnet20_cifar", num_classes=3)
    with pytest.raises(RuntimeError, match="runtime.device"):
        fz.transform(frame)


def test_device_key_reads_the_environment(monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_TORCH_RUNTIME_DEVICE", "cpu")
    tconfig.unset("runtime.device")
    assert str(tconfig.resolve_device()) == "cpu"


def _served_lm():
    from mmlspark_tpu_torch.serve import Server
    tconfig.set("runtime.device", "cpu")
    try:
        model = TorchModel().set_model("transformer_lm_tiny", seed=0)
        return Server({"lm": model}, start=False)
    finally:
        tconfig.unset("runtime.device")


def test_server_raises_instead_of_running_on_the_cpu(default_device):
    from mmlspark_tpu_torch.serve import Server
    model = TorchModel(inputCol="x", outputCol="f")
    model.set_model("mlp_tabular", input_dim=4, hidden=[8], num_classes=2)
    with pytest.raises(RuntimeError, match="is_available"):
        Server({"mlp": model}, start=False)


def test_enable_generate_raises_instead_of_running_on_the_cpu(
        default_device):
    srv = _served_lm()
    try:
        with pytest.raises(RuntimeError, match="is_available"):
            srv.enable_generate("lm", start=False)
    finally:
        srv.close()


def test_serve_http_raises_instead_of_running_on_the_cpu(default_device):
    from mmlspark_tpu_torch.serve.http import serve_http
    srv = _served_lm()
    try:
        with pytest.raises(RuntimeError, match="is_available"):
            serve_http(srv, port=0)
    finally:
        srv.close()


def _registry():
    from mmlspark_tpu_torch.serve import ModelRegistry
    return ModelRegistry()


def _model_entry():
    from mmlspark_tpu_torch.serve import ModelEntry
    model = TorchModel(inputCol="x", outputCol="f")
    model.set_model("mlp_tabular", input_dim=4, hidden=[8], num_classes=2)
    return ModelEntry("mlp", model)


def _kv_cache():
    from mmlspark_tpu_torch.serve import KVCacheManager
    return KVCacheManager(layers=1, heads=1, head_dim=2, num_blocks=4,
                          block_tokens=2)


def _kv_cache_from_config():
    from mmlspark_tpu_torch.serve import KVCacheManager
    return KVCacheManager.from_config(layers=1, heads=1, head_dim=2)


def _int8_kv_cache():
    from mmlspark_tpu_torch.serve import KVCacheManager
    return KVCacheManager(layers=1, heads=1, head_dim=2, num_blocks=4,
                          block_tokens=2, kv_dtype="int8")


def _int8_kv_cache_from_config():
    from mmlspark_tpu_torch.serve import KVCacheManager
    tconfig.set("generate.kv_dtype", "int8")
    try:
        return KVCacheManager.from_config(layers=1, heads=1, head_dim=2)
    finally:
        tconfig.unset("generate.kv_dtype")


def _fleet():
    from mmlspark_tpu_torch.serve import Fleet
    model = TorchModel(inputCol="x", outputCol="f")
    model.set_model("mlp_tabular", input_dim=4, hidden=[8], num_classes=2)
    return Fleet({"mlp": model}, replicas=2, start=False)


@pytest.mark.parametrize("make", [_registry, _model_entry, _kv_cache,
                                  _kv_cache_from_config, _int8_kv_cache,
                                  _int8_kv_cache_from_config, _fleet],
                         ids=["registry", "model_entry", "kv_cache",
                              "kv_cache_from_config", "int8_kv_cache",
                              "int8_kv_cache_from_config", "fleet"])
def test_serve_parts_raise_instead_of_running_on_the_cpu(default_device,
                                                          make):
    with pytest.raises(RuntimeError, match="is_available"):
        make()


def test_draft_entry_raises_instead_of_running_on_the_cpu(default_device):
    """A lane with a draft model resolves the device before it builds
    either entry."""
    from mmlspark_tpu_torch.serve import Server
    tconfig.set("runtime.device", "cpu")
    try:
        srv = Server({"lm": TorchModel().set_model("transformer_lm_tiny",
                                                   seed=0),
                      "draft": TorchModel().set_model("transformer_lm_tiny",
                                                      seed=1)}, start=False)
    finally:
        tconfig.unset("runtime.device")
    tconfig.set("generate.draft_model", "draft")
    try:
        with pytest.raises(RuntimeError, match="is_available"):
            srv.enable_generate("lm", start=False)
    finally:
        tconfig.unset("generate.draft_model")
        srv.close()


def _linear():
    import torch
    return torch.nn.Linear(2, 2)


def _loss(module, batch, gen):
    return module(batch["x"]).sum()


def test_resilient_train_loop_raises_instead_of_running_on_the_cpu(
        default_device, tmp_path):
    """A loop's trainer resolves ``runtime.device``: without CUDA the loop
    cannot be built over one, so no step or checkpoint ever lands on the
    CPU unasked."""
    from mmlspark_tpu_torch.parallel.checkpoint import TrainCheckpointer
    from mmlspark_tpu_torch.parallel.optim import sgd
    from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer
    from mmlspark_tpu_torch.reliability.resilient import ResilientTrainLoop
    ckpt = TrainCheckpointer(str(tmp_path / "ck"))
    try:
        with pytest.raises(RuntimeError, match="is_available"):
            ResilientTrainLoop(DistributedTrainer(_loss, sgd(0.1)), ckpt,
                               _linear, save_every=1)
    finally:
        ckpt.close()


def test_checkpoint_restore_raises_instead_of_loading_onto_the_cpu(
        default_device, tmp_path):
    """A checkpoint written on the CPU (asked for explicitly) does not
    restore onto the CPU by default: the restoring trainer resolves
    ``runtime.device`` and raises without CUDA."""
    from mmlspark_tpu_torch.parallel.checkpoint import TrainCheckpointer
    from mmlspark_tpu_torch.parallel.optim import sgd
    from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer
    cpu_trainer = DistributedTrainer(_loss, sgd(0.1), device="cpu")
    ckpt = TrainCheckpointer(str(tmp_path / "ck"))
    try:
        ckpt.save(cpu_trainer.init(_linear), step=1, wait=True)
        with pytest.raises(RuntimeError, match="is_available"):
            ckpt.restore(DistributedTrainer(_loss, sgd(0.1)), _linear)
        with pytest.raises(RuntimeError, match="is_available"):
            ckpt.restore_or_init(DistributedTrainer(_loss, sgd(0.1)),
                                 _linear)
    finally:
        ckpt.close()


def test_nccl_refuses_too_few_cards_and_never_switches_to_gloo(
        monkeypatch):
    """``runtime.dist_backend="nccl"`` (the default) with fewer visible
    cards than local ranks raises before any rendezvous, naming gloo as
    the caller's choice, and leaves no process group behind: nothing
    picks another backend by itself. gloo is accepted."""
    import torch
    import torch.distributed as dist
    from mmlspark_tpu_torch.parallel import mesh
    from mmlspark_tpu_torch.testing.ranks import free_port
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="gloo"):
        mesh.check_backend("nccl", cards + 1)
    mesh.check_backend("gloo", cards + 2)
    with pytest.raises(ValueError, match="nccl"):
        mesh.check_backend("mpi", 1)
    tconfig.set("runtime.dist_backend", "nccl")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(cards + 1))
    try:
        with pytest.raises(RuntimeError, match="one CUDA card a rank"):
            mesh.initialize_multihost(f"127.0.0.1:{free_port()}",
                                      cards + 1, 0, timeout_s=5)
        assert not dist.is_initialized()
    finally:
        tconfig.unset("runtime.dist_backend")
    with pytest.raises(ValueError, match="coordinator_address"):
        mesh.initialize_multihost(num_processes=2, process_id=0)
