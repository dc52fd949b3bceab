"""The pretrained-weight import against the JAX package's
(``mmlspark_tpu/models/convert.py``), on the CPU: the flax msgpack codec,
the torch npz rules, ``validate_params``, ``import_pretrained`` and the
committed trained fixture scored through the downloader and the
featurizer.

Tolerances:
- the codec, the npz rules, validation and the schemas: exact (bytes,
  leaves, dtypes, path lists and messages equal);
- golden-image ``pool`` features of the fp32 import against the JAX
  featurizer on the same images: 1e-4 (fp32 convs summed in other
  orders); the import with the reference test's arguments (bf16 convs)
  against ``golden.npz``: 2e-2, the reference test's own tolerance;
- the torch-npz MLP against the torch forward and the JAX ``JaxModel``:
  rtol 1e-4 / atol 1e-5, the reference test's.
"""
import os
import subprocess
import sys
import textwrap

import msgpack
import numpy as np
import pytest
import torch
from flax import serialization as flax_serialization

from mmlspark_tpu.core.frame import Frame as JFrame
from mmlspark_tpu.core.schema import ColumnSchema as JColumnSchema
from mmlspark_tpu.core.schema import DType as JDType
from mmlspark_tpu.core.schema import ImageValue as JImageValue
from mmlspark_tpu.image.featurizer import ImageFeaturizer as JImageFeaturizer
from mmlspark_tpu.models import convert as jconvert
from mmlspark_tpu.models import downloader as jdl
from mmlspark_tpu.models.jax_model import JaxModel
from mmlspark_tpu.models.zoo import available_models as javailable
from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.core.schema import ColumnSchema, DType, ImageValue
from mmlspark_tpu_torch.image.featurizer import ImageFeaturizer
from mmlspark_tpu_torch.models import _msgpack
from mmlspark_tpu_torch.models import convert
from mmlspark_tpu_torch.models import downloader as dl
from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.models.zoo import available_models, shared_models
from mmlspark_tpu_torch.utils import config as tconfig

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
FIXTURES = os.path.join(TESTS, "data", "pretrained")
MSGPACK = os.path.join(FIXTURES, "resnet20_synthetic.msgpack")
GOLDEN = os.path.join(FIXTURES, "golden.npz")
IMPORT = dict(dataset="synthetic-4class", input_mean=[127.5],
              input_std=[127.5], num_classes=4)


@pytest.fixture(autouse=True)
def on_cpu():
    tconfig.set("runtime.device", "cpu")
    yield
    tconfig.unset("runtime.device")


def _leaves(tree, prefix=""):
    """(path, leaf) in the tree's own order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def _assert_same_tree(got, want):
    got, want = list(_leaves(got)), list(_leaves(want))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert type(a) is type(b), k
        if isinstance(a, (np.ndarray, np.generic)):
            assert a.dtype == b.dtype and np.shape(a) == np.shape(b), k
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert a == b, k


# -- the codec ----------------------------------------------------------------

def test_fixture_reads_leaf_for_leaf_as_the_reference():
    got = convert.from_flax_msgpack(MSGPACK)
    want = jconvert.from_flax_msgpack(MSGPACK)
    _assert_same_tree(got, want)
    assert len(list(_leaves(got))) == 63
    assert not any(v.flags.writeable for _, v in _leaves(got))
    with open(MSGPACK, "rb") as f:
        _assert_same_tree(convert.from_flax_msgpack(f.read()), want)


def test_written_bytes_equal_the_reference_and_each_reads_the_other(
        tmp_path):
    tree = jconvert.from_flax_msgpack(MSGPACK)
    path = str(tmp_path / "port.msgpack")
    got = convert.to_flax_msgpack(tree, path)
    want = jconvert.to_flax_msgpack(tree)
    assert got == want
    with open(MSGPACK, "rb") as f:
        assert got == f.read()
    with open(path, "rb") as f:
        assert f.read() == got
    _assert_same_tree(jconvert.from_flax_msgpack(got),
                      convert.from_flax_msgpack(want))


def _mixed_tree():
    """Every leaf kind flax writes: arrays of each dtype family (bf16,
    complex, bool, empty, 0-d), numpy scalars, native complex, str, int,
    float, None, bytes and lists; dict keys out of order."""
    import ml_dtypes
    rng = np.random.default_rng(0)
    return {
        "z": rng.normal(size=(3, 4)).astype(np.float32),
        "b": {"i8": np.arange(-5, 5, dtype=np.int8),
              "u64": np.array([2 ** 63], np.uint64),
              "bf16": rng.normal(size=7).astype(ml_dtypes.bfloat16),
              "c64": np.array([1 + 2j], np.complex64),
              "bool": np.array([True, False]),
              "empty": np.zeros((2, 0)), "scalar0d": np.array(3.5)},
        "a": {"np_scalar": np.float32(2.5), "np_int": np.int64(-7),
              "complex": 1.5 - 2j, "str": "é" * 40, "int": -300,
              "float": 0.1, "none": None, "bytes": b"\x00" * 300,
              "list": [np.ones(2, np.float16), 7, "x"]},
    }


def test_every_leaf_kind_writes_flax_bytes_and_reads_back():
    tree = _mixed_tree()
    want = flax_serialization.msgpack_serialize(tree)
    assert _msgpack.serialize(tree) == want
    _assert_same_tree(_msgpack.restore(want),
                      flax_serialization.msgpack_restore(want))


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1,
    -2 ** 63, 1.5, float("inf"), "", "a" * 31, "b" * 32, "c" * 255,
    "d" * 256, "e" * 70000, b"", b"x" * 256, b"y" * 70000, None, True, False,
    [], list(range(15)), list(range(16)), list(range(70000)),
    {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
    {str(i): i for i in range(70000)}])
def test_each_item_takes_msgpacks_smallest_encoding(value):
    want = msgpack.packb(value, use_bin_type=True, strict_types=True)
    assert _msgpack.packb(value) == want
    assert _msgpack.unpackb(want) == msgpack.unpackb(want, raw=False)


def test_strict_types_refuse_what_flax_refuses():
    for bad in ((1, 2), object(), {1: 2}.keys()):
        with pytest.raises(TypeError):
            flax_serialization.msgpack_serialize({"a": bad})
        with pytest.raises(TypeError):
            _msgpack.serialize({"a": bad})
    with pytest.raises(ValueError, match="map key"):
        _msgpack.unpackb(msgpack.packb({1: 2}))


def test_chunked_leaves_round_trip_as_the_reference(monkeypatch):
    monkeypatch.setattr(flax_serialization, "MAX_CHUNK_SIZE", 4096)
    monkeypatch.setattr(_msgpack, "MAX_CHUNK_SIZE", 4096)
    rng = np.random.default_rng(1)
    tree = {"params": {"big": rng.normal(size=(50, 70)).astype(np.float32),
                       "small": np.arange(10, dtype=np.float32),
                       "wide": rng.integers(0, 9, 5000).astype(np.int64)}}
    want = jconvert.to_flax_msgpack(tree)
    got = convert.to_flax_msgpack(tree)
    assert got == want
    raw = msgpack.unpackb(got, raw=False, ext_hook=lambda c, d: c)
    assert raw["params"]["big"]["__msgpack_chunked_array__"] is True
    assert len(raw["params"]["big"]["chunks"]) == 4     # 14000 B / 4096
    assert raw["params"]["small"] == 1                  # an ext, unchunked
    _assert_same_tree(convert.from_flax_msgpack(want),
                      jconvert.from_flax_msgpack(got))
    _assert_same_tree(convert.from_flax_msgpack(got), tree)


def test_the_port_reads_and_writes_msgpack_without_flax_or_msgpack():
    """In a fresh interpreter where importing flax or msgpack fails, the
    fixture reads and writes back its own bytes."""
    code = textwrap.dedent(f"""
        import sys
        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("flax", "msgpack", "jax"):
                    raise ImportError("refused: " + name)
        sys.meta_path.insert(0, Refuse())
        from mmlspark_tpu_torch.models import convert
        tree = convert.from_flax_msgpack({MSGPACK!r})
        with open({MSGPACK!r}, "rb") as f:
            assert convert.to_flax_msgpack(tree) == f.read()
        assert not any(m.split(".")[0] in ("flax", "msgpack", "jax")
                       for m in sys.modules)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "ok"


# -- torch npz ----------------------------------------------------------------

def _torch_layouts():
    """The reference test's layout dict (tests/test_convert.py)."""
    return {
        "fc.weight": np.arange(6.0).reshape(2, 3),
        "fc.bias": np.zeros(2),
        "conv.weight": np.arange(24.0).reshape(2, 3, 2, 2),
        "conv1d.weight": np.arange(12.0).reshape(2, 3, 2),
        "bn.weight": np.ones(4),
        "bn.bias": np.zeros(4),
        "bn.running_mean": np.zeros(4),
        "bn.running_var": np.ones(4),
        "bn.num_batches_tracked": np.asarray(7),
    }


@pytest.mark.parametrize("as_file", [False, True])
def test_torch_npz_gives_the_reference_tree(tmp_path, as_file):
    sd = _torch_layouts()
    source = sd
    if as_file:
        source = str(tmp_path / "sd.npz")
        np.savez(source, **sd)
    got = convert.from_torch_npz(source)
    _assert_same_tree(got, jconvert.from_torch_npz(source))
    p = got["params"]
    assert p["conv"]["kernel"].shape == (2, 2, 3, 2)       # HWIO
    assert p["conv1d"]["kernel"].shape == (2, 3, 2)        # (k, in, out)
    assert set(p["bn"]) == {"scale", "bias", "mean", "var"}


def test_torch_npz_of_a_port_state_equals_to_jax_params():
    """The port's modules carry the flax names, so its ResNet state dict
    exported as numpy imports as the flax tree ``to_jax_params`` gives."""
    from mmlspark_tpu_torch.models.zoo import build_model, init_state
    state = init_state(build_model("resnet20_cifar", num_classes=4)["module"])
    got = convert.from_torch_npz(state)
    want = convert.to_jax_params(state)
    assert sorted(k for k, _ in _leaves(got)) == sorted(
        k for k, _ in _leaves(want))
    flat = dict(_leaves(want))
    for k, v in _leaves(got):
        np.testing.assert_array_equal(v, flat[k])


# -- validation ---------------------------------------------------------------

def _message(fn, *args, **kwargs) -> str:
    with pytest.raises(ValueError) as err:
        fn(*args, **kwargs)
    return str(err.value)


def test_validate_params_passes_and_returns_the_reference_dtypes():
    params = convert.from_flax_msgpack(MSGPACK)

    def widen(tree):
        if isinstance(tree, dict):
            return {k: widen(v) for k, v in tree.items()}
        return tree.astype(np.float64)
    wide = widen(params)
    for tree in (params, wide):
        got = convert.validate_params("resnet20_cifar", tree, num_classes=4)
        want = jconvert.validate_params("resnet20_cifar", tree,
                                        num_classes=4)
        _assert_same_tree(got, want)
        assert all(v.dtype == np.float32 for _, v in _leaves(got))


def test_validate_params_raises_the_reference_lists():
    params = convert.from_flax_msgpack(MSGPACK)
    got = _message(convert.validate_params, "resnet20_cifar", params,
                   num_classes=10)
    assert "shape mismatches" in got and "params/head/kernel" in got
    assert got == _message(jconvert.validate_params, "resnet20_cifar",
                           params, num_classes=10)
    broken = convert.from_flax_msgpack(MSGPACK)
    del broken["params"]["head"]
    broken["params"]["extra"] = {"kernel": np.zeros(3)}
    got = _message(convert.validate_params, "resnet20_cifar", broken,
                   num_classes=4)
    assert "missing: ['params/head/bias', 'params/head/kernel']" in got
    assert "unexpected: ['params/extra/kernel']" in got
    assert got == _message(jconvert.validate_params, "resnet20_cifar",
                           broken, num_classes=4)


@pytest.mark.parametrize("architecture", shared_models())
def test_validate_target_equals_the_reference_init(architecture):
    """Every architecture's target (paths, shapes, dtypes), built from the
    meta module, equals the reference's ``jax.eval_shape`` of its init."""
    import jax
    import jax.numpy as jnp
    from mmlspark_tpu.models.zoo import build_model as jbuild
    assert shared_models() == javailable()
    assert set(available_models()) - set(shared_models()) == {
        "vmoe_b16", "vmoe_tiny"}
    spec = jbuild(architecture)
    shape = (1,) + tuple(spec["input_shape"])
    dt = jnp.int32 if spec.get("input_dtype") == "int32" else jnp.float32
    target = jax.eval_shape(lambda: spec["module"].init(
        jax.random.PRNGKey(0), jnp.zeros(shape, dt)))
    want = {k: (tuple(v.shape), np.dtype(v.dtype))
            for k, v in _leaves(dict(target))}
    module = convert._meta_spec(architecture, {})["module"]
    assert all(p.is_meta for p in module.parameters())
    assert convert._target(module) == want


# -- publishing, the downloader and the featurizer ----------------------------

def _schemas(tmp_path, **extra):
    repos = (dl.LocalRepo(str(tmp_path / "port")),
             jdl.LocalRepo(str(tmp_path / "jax")))
    params = convert.from_flax_msgpack(MSGPACK)
    got = convert.import_pretrained(repos[0], "r20", "resnet20_cifar",
                                    params, **IMPORT, **extra)
    want = jconvert.import_pretrained(repos[1], "r20", "resnet20_cifar",
                                      params, **IMPORT, **extra)
    return repos, got, want


def test_import_pretrained_schema_equals_the_reference(tmp_path):
    repos, got, want = _schemas(tmp_path)
    got_fields, want_fields = vars(got), vars(want)
    assert got.hash and want.hash
    assert {k: v for k, v in got_fields.items() if k != "hash"} == {
        k: v for k, v in want_fields.items() if k != "hash"}
    assert got.layerNames == ["pool", "head"] and got.inputNode == "pool"
    # each package's downloader loads the other's repository
    port_tree = dl.ModelDownloader(repos[1]).load_params("r20")
    jax_tree = jdl.ModelDownloader(repos[0]).load_params("r20")
    _assert_same_tree(port_tree, dl.ModelDownloader(repos[0])
                      .load_params("r20"))
    _assert_same_tree(jax_tree, jdl.ModelDownloader(repos[1])
                      .load_params("r20"))


def _golden_frames():
    g = np.load(GOLDEN)
    frames = []
    for frame_cls, col_cls, dtype, value_cls in (
            (Frame, ColumnSchema, DType, ImageValue),
            (JFrame, JColumnSchema, JDType, JImageValue)):
        vals = np.empty(len(g["images"]), dtype=object)
        for i, im in enumerate(g["images"]):
            vals[i] = value_cls(path=f"mem://{i}",
                                data=np.ascontiguousarray(im))
        frames.append(frame_cls.from_dict({"i": np.arange(len(vals))})
                      .with_column_values(col_cls("image", dtype.IMAGE),
                                          vals))
    return g, frames


def _featurize(cls, downloader, frame, cut):
    fz = cls(inputCol="image", outputCol="features", cutOutputLayers=cut,
             miniBatchSize=8)
    fz.set_model_from_downloader(downloader, "r20")
    return np.asarray(fz.transform(frame).column("features"))


def test_golden_features_of_the_fp32_import_match_the_jax_featurizer(
        tmp_path):
    (port, jax_repo), _, _ = _schemas(tmp_path, dtype="float32")
    g, (frame, jframe) = _golden_frames()
    got = _featurize(ImageFeaturizer, dl.ModelDownloader(port), frame, 1)
    want = _featurize(JImageFeaturizer, jdl.ModelDownloader(jax_repo),
                      jframe, 1)
    assert got.shape == want.shape == (8, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, g["pool"], rtol=2e-2, atol=2e-2)


def test_golden_features_and_labels_of_the_reference_import(tmp_path):
    """The reference test's import (bf16 convs): ``pool`` within its 2e-2
    of the golden table, and the head predicts all 8 labels."""
    (port, _), schema, _ = _schemas(tmp_path)
    assert schema.architectureArgs == {"num_classes": 4}
    g, (frame, _) = _golden_frames()
    downloader = dl.ModelDownloader(port)
    feats = _featurize(ImageFeaturizer, downloader, frame, 1)
    np.testing.assert_allclose(feats, g["pool"], rtol=2e-2, atol=2e-2)
    logits = _featurize(ImageFeaturizer, downloader, frame, 0)
    assert (np.argmax(logits, axis=-1) == g["labels"]).all()
    assert float(g["eval_accuracy"]) > 0.9


def test_torch_npz_mlp_scores_as_the_torch_forward_and_jax():
    """The reference test's MLP: a torch state_dict exported as numpy,
    imported, validated and scored by TorchModel and by JaxModel."""
    class TorchMLP(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.mlp_fc0 = torch.nn.Linear(6, 16)
            self.head = torch.nn.Linear(16, 3)

        def forward(self, x):
            return self.head(torch.relu(self.mlp_fc0(x)))

    torch.manual_seed(0)
    tm = TorchMLP().eval()
    sd = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    arch = dict(input_dim=6, hidden=[16], num_classes=3, dtype="float32")
    params = convert.validate_params("mlp_tabular",
                                     convert.from_torch_npz(sd), **arch)
    X = np.random.default_rng(0).normal(size=(20, 6)).astype(np.float32)
    ours = TorchModel(inputCol="x", outputCol="scores", miniBatchSize=8)
    ours.set_model("mlp_tabular", params=params, **arch)
    got = np.asarray(ours.transform(Frame.from_dict({"x": X}))
                     .column("scores"))
    theirs = JaxModel(inputCol="x", outputCol="scores", miniBatchSize=8)
    theirs.set_model("mlp_tabular", params=params, **arch)
    want_jax = np.asarray(theirs.transform(JFrame.from_dict({"x": X}))
                          .column("scores"))
    want = tm(torch.from_numpy(X)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, want_jax, rtol=1e-4, atol=1e-5)
