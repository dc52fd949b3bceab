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
    assert int(count) >= 20        # every module of the slice was imported
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
