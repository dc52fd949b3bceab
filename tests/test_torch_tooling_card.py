"""Capture-all nodes, the downloader and the chaos scenarios on the card.

Runs only on a CUDA card (``cuda`` marker; skipped here) and imports no
JAX, so it runs on the card's machine with
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_tooling_card.py``:

- a captured conv, norm and block output of ResNet-20 (fp32, TF32 off) on
  the card equal to the same nodes captured on the CPU within 1e-4, and a
  bf16 node keeps its dtype's layout (NHWC) and the card's K2 launch;
- a ``LocalRepo`` written from the card's state dict loads back through
  ``ModelDownloader.to_torch_model`` and scores bit-equal on the card;
- the committed trained ResNet-20 (flax msgpack) imported by
  ``convert.import_pretrained`` (fp32 architecture) and scored through
  ``ModelDownloader`` and ``ImageFeaturizer`` on the card, K2 in the
  path: ``pool`` within 2e-2 of the golden table (the reference test's
  tolerance) and within 1e-3 of the CPU's, all 8 labels predicted;
- ``DistributedTrainer.abstract_state`` of ResNet-50 leaves the card's
  allocator where it was;
- the ``train`` and ``fleet`` chaos scenarios green on the card, and
  ``cli chaos --scenario fleet_sharded --nprocs 2`` (two ranks over
  gloo on the card) exits 0 with a passed verdict.
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.utils import config as tconfig

ARCH = dict(num_classes=10, dtype="float32")
NODES = ["stem_conv/out", "stage1_block0/norm2/out", "stage2_block2/out"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tconfig.set("runtime.device", "cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda", 0)
    tconfig.unset("runtime.device")


def _score(node, x, **params):
    tm = TorchModel(inputCol="x", outputCol="o", miniBatchSize=4,
                    outputNodeName=node, **params)
    tm.set_model("resnet20_cifar", seed=0, **ARCH)
    return np.asarray(tm.transform(Frame.from_dict({"x": x})).column("o"))


@pytest.mark.cuda
@pytest.mark.parametrize("node", NODES)
def test_captured_node_on_the_card_equals_the_cpu(card, node):
    x = np.random.default_rng(0).normal(size=(6, 32 * 32 * 3)).astype(
        np.float32)
    got = _score(node, x)
    tconfig.set("runtime.device", "cpu")
    want = _score(node, x)
    tconfig.set("runtime.device", "cuda")
    assert got.shape == want.shape and got.shape[-1] in (16, 32, 64)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_captured_node_through_k2_on_the_card(card):
    from mmlspark_tpu_torch import kernels
    x = np.random.default_rng(1).integers(0, 256, (8, 40 * 40 * 3)).astype(
        np.uint8)
    kernels.reset_launches()
    got = _score("stage2_block2/out", x, computeDtype="bfloat16",
                 devicePreprocess={"srcShape": [40, 40, 3],
                                   "resize": [32, 32]})
    assert kernels.CROP_RESIZE_NORMALIZE.launches == 2
    assert got.shape == (8, 8, 8, 64) and np.isfinite(got).all()


@pytest.mark.cuda
def test_downloaded_model_scores_bit_equal_on_the_card(card, tmp_path):
    from mmlspark_tpu_torch.models import downloader as dl
    tm = TorchModel(inputCol="x", outputCol="o")
    tm.set_model("resnet20_cifar", seed=3, **ARCH)
    state = {k: torch.from_numpy(np.asarray(v)).to(card)
             for k, v in tm._state["params"].items()}
    repo = dl.LocalRepo(str(tmp_path))
    repo.save_model(dl.ModelSchema(name="r20", architecture="resnet20_cifar",
                                   architectureArgs=dict(ARCH)), state)
    loaded = dl.ModelDownloader(repo).to_torch_model("r20", inputCol="x",
                                                     outputCol="o")
    x = np.random.default_rng(2).normal(size=(5, 32 * 32 * 3)).astype(
        np.float32)
    frame = Frame.from_dict({"x": x})
    np.testing.assert_array_equal(
        np.asarray(loaded.transform(frame).column("o")),
        np.asarray(tm.transform(frame).column("o")))


@pytest.mark.cuda
def test_imported_trained_resnet20_scores_golden_on_the_card(card, tmp_path):
    import os
    from mmlspark_tpu_torch import kernels
    from mmlspark_tpu_torch.core.schema import ColumnSchema, DType, ImageValue
    from mmlspark_tpu_torch.image.featurizer import ImageFeaturizer
    from mmlspark_tpu_torch.models import convert
    from mmlspark_tpu_torch.models import downloader as dl
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "data", "pretrained")
    golden = np.load(os.path.join(fixtures, "golden.npz"))
    repo = dl.LocalRepo(str(tmp_path))
    convert.import_pretrained(
        repo, "r20", "resnet20_cifar", convert.from_flax_msgpack(
            os.path.join(fixtures, "resnet20_synthetic.msgpack")),
        dataset="synthetic-4class", input_mean=[127.5], input_std=[127.5],
        num_classes=4, dtype="float32")
    images = np.empty(len(golden["images"]), dtype=object)
    for i, im in enumerate(golden["images"]):
        images[i] = ImageValue(path=f"mem://{i}",
                               data=np.ascontiguousarray(im))
    frame = Frame.from_dict({"i": np.arange(len(images))}).with_column_values(
        ColumnSchema("image", DType.IMAGE), images)

    def featurize(cut):
        fz = ImageFeaturizer(cutOutputLayers=cut, miniBatchSize=8)
        fz.set_model_from_downloader(dl.ModelDownloader(repo), "r20")
        return np.asarray(fz.transform(frame).column("features"))

    kernels.reset_launches()
    feats, logits = featurize(1), featurize(0)
    assert kernels.CROP_RESIZE_NORMALIZE.launches == 2
    tconfig.set("runtime.device", "cpu")
    cpu = featurize(1)
    tconfig.set("runtime.device", "cuda")
    np.testing.assert_allclose(feats, golden["pool"], rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(feats, cpu, rtol=1e-3, atol=1e-3)
    assert (np.argmax(logits, axis=-1) == golden["labels"]).all()


@pytest.mark.cuda
def test_abstract_state_allocates_nothing_on_the_card(card):
    """ResNet-50's train state under adam, abstractly: the card's
    allocator holds the same bytes before and after, every tensor is on
    the meta device, and ``init`` then places the same shapes there."""
    from mmlspark_tpu_torch.models.zoo import build_model
    from mmlspark_tpu_torch.parallel import optim
    from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer
    trainer = DistributedTrainer(lambda m, b, g: None, optim.adam(1e-3),
                                 device=card)

    def init_fn():
        return build_model("resnet50", num_classes=1000)["module"]

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    abstract, shardings = trainer.abstract_state(init_fn)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before and shardings is None
    assert all(t.is_meta for t in abstract["params"].values())
    state = trainer.init(init_fn)
    assert {n: tuple(p.shape) for n, p in
            state["module"].named_parameters()} == {
        n: tuple(t.shape) for n, t in abstract["params"].items()}


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", [("train", {"requests": 12}),
                                     ("fleet", {"replicas": 3,
                                                "requests": 12})])
def test_chaos_scenario_green_on_the_card(card, tmp_path, name, kw):
    from mmlspark_tpu_torch.reliability import chaos
    v = chaos.run_named(name, 0, str(tmp_path / name), **kw)
    assert v["passed"] and all(v["invariants"].values()), v["errors"]


@pytest.mark.cuda
def test_cli_chaos_fleet_sharded_on_two_ranks_of_the_card(card, tmp_path):
    """The mesh-bound fleet scenario through the CLI: two ranks sharing
    the card (gloo, picked by the launcher), rank 0 leading; exit 0, the
    printed verdict all-green, no placement left on either rank."""
    import json
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "fleet_sharded"
    proc = subprocess.run(
        [sys.executable, "-m", "mmlspark_tpu_torch.cli", "chaos",
         "--scenario", "fleet_sharded", "--seed", "0", "--nprocs", "2",
         "--platform", "cuda", "--replicas", "3", "--requests", "12",
         "--out", str(out)], cwd=repo, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    verdict = json.loads(proc.stdout)
    assert verdict["passed"] and all(verdict["invariants"].values())
    assert verdict["mesh"] == "data=-1,tensor=2"
    assert verdict["ranks"]["world"] == 2
    assert verdict["ranks"]["placements_left"] == [[], []]
