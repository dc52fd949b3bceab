"""The whole slice against the JAX package: ``ImageFeaturizer`` ->
``TorchModel`` -> preprocess -> ResNet, in both packages, with the same
``resnet20_cifar`` parameters (built with float32 dtype) and the same
numpy-seeded images.

Tolerances:
- 32x32 uint8 into a 32x32 net: the fused preprocess is an identity
  resample, exact on both sides, so only fp32 conv order differs: 1e-4.
- 40x40 uint8: a real resize; a rare one-quantum requantize tie (see
  ``test_torch_preprocess.py``) propagates through the net: atol 0.02, the
  bound ``tests/test_image.py`` holds fused against host features to.
- ragged sizes take the host resize (numpy, the same code in both
  packages) and then the float route: 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.frame import Frame as JFrame
from mmlspark_tpu.core.schema import ColumnSchema as JColumnSchema
from mmlspark_tpu.core.schema import DType as JDType
from mmlspark_tpu.core.schema import ImageValue as JImageValue
from mmlspark_tpu.image.featurizer import ImageFeaturizer as JImageFeaturizer
from mmlspark_tpu.models.jax_model import JaxModel
from mmlspark_tpu.models.zoo import build_model as jbuild
from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.core.schema import (
    ColumnSchema, DType, ImageValue, SchemaError,
)
from mmlspark_tpu_torch.core.serialization import load_stage, save_stage
from mmlspark_tpu_torch.image.featurizer import ImageFeaturizer
from mmlspark_tpu_torch.image.transformer import ImageTransformer
from mmlspark_tpu_torch.models import residency
from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.observability import syncs
from mmlspark_tpu_torch.utils import config as tconfig

ARCH = dict(num_classes=10, dtype="float32")


@pytest.fixture(autouse=True)
def _cpu_device():
    tconfig.set("runtime.device", "cpu")
    residency.clear()
    yield
    tconfig.unset("runtime.device")
    tconfig.unset("runtime.device_cache_mb")
    residency.clear()


@pytest.fixture(scope="module")
def jparams():
    """resnet20_cifar flax params as numpy, shared by both packages."""
    module = jbuild("resnet20_cifar", **ARCH)["module"]
    params = jax.jit(module.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 32, 32, 3)))
    return jax.tree_util.tree_map(np.array, params)


def _frames(images):
    """The same ImageValue rows as a port Frame and a JAX Frame."""
    out = []
    for frame_cls, col_cls, dtype, value_cls in (
            (Frame, ColumnSchema, DType, ImageValue),
            (JFrame, JColumnSchema, JDType, JImageValue)):
        vals = np.empty(len(images), dtype=object)
        for i, im in enumerate(images):
            vals[i] = value_cls(path=f"mem://{i}", data=im)
        frame = frame_cls.from_dict({"row": np.arange(len(images))},
                                    num_partitions=2)
        out.append(frame.with_column_values(col_cls("image", dtype.IMAGE),
                                            vals))
    return out


def _u8_images(seed, n, h, w):
    return list(np.random.default_rng(seed).integers(
        0, 256, (n, h, w, 3), dtype=np.uint8))


def _featurize_both(jparams, images, cut, **kw):
    tframe, jframe = _frames(images)
    feats = []
    for cls, frame in ((ImageFeaturizer, tframe), (JImageFeaturizer, jframe)):
        fz = cls(cutOutputLayers=cut, miniBatchSize=4, **kw)
        fz.set_model("resnet20_cifar", params=jparams, **ARCH)
        feats.append((fz, np.asarray(fz.transform(frame).column("features"))))
    (tfz, got), (_, want) = feats
    return tfz, got, want


@pytest.mark.parametrize("cut,width", [(1, 64), (0, 10)])
def test_uint8_identity_resample_matches_jax(jparams, cut, width):
    tfz, got, want = _featurize_both(jparams, _u8_images(1, 6, 32, 32), cut)
    assert tfz._tm_cache.get("devicePreprocess") == {
        "srcShape": [32, 32, 3], "resize": [32, 32]}
    assert got.shape == want.shape == (6, width)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_uint8_real_resize_matches_jax(jparams):
    tfz, got, want = _featurize_both(jparams, _u8_images(2, 6, 40, 40), 1)
    assert tfz._tm_cache.get("devicePreprocess") == {
        "srcShape": [40, 40, 3], "resize": [32, 32]}
    np.testing.assert_allclose(got, want, atol=0.02, rtol=0)


def test_ragged_sizes_take_the_host_resize_and_match_jax(jparams):
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in [(20, 30), (32, 32), (41, 17), (20, 30), (9, 50)]]
    tfz, got, want = _featurize_both(jparams, images, 1)
    assert tfz._tm_cache.get("devicePreprocess") == {}
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_torch_model_matches_jax_model_on_a_float_vector_column(jparams):
    x = np.random.default_rng(4).normal(
        size=(7, 32 * 32 * 3)).astype(np.float32)
    outs = []
    for cls, frame_cls in ((TorchModel, Frame), (JaxModel, JFrame)):
        model = cls(inputCol="x", outputCol="scores", miniBatchSize=4)
        model.set_model("resnet20_cifar", params=jparams, **ARCH)
        outs.append(np.asarray(model.transform(
            frame_cls.from_dict({"x": x})).column("scores")))
    assert outs[0].shape == (7, 10)
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-4, rtol=0)


def test_device_preprocess_crop_and_normalize_on_float_input_match_jax(
        jparams):
    """The float route of devicePreprocess (center-crop + resize + the
    model's input mean/std) against JAX's jnp route on the same frame."""
    x = np.random.default_rng(5).uniform(
        0, 255, size=(5, 36 * 40 * 3)).astype(np.float32)
    dp = {"srcShape": [36, 40, 3], "crop": [34, 34], "resize": [32, 32]}
    norm = dict(input_mean=[120.0, 110.0, 100.0], input_std=[60.0, 61, 62])
    outs = []
    for cls, frame_cls in ((TorchModel, Frame), (JaxModel, JFrame)):
        model = cls(inputCol="x", outputCol="f", miniBatchSize=4,
                    outputNodeName="pool", devicePreprocess=dp)
        model.set_model("resnet20_cifar", params=jparams, **norm, **ARCH)
        outs.append(np.asarray(model.transform(
            frame_cls.from_dict({"x": x})).column("f")))
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-4, rtol=0)


def test_device_cache_modes_agree():
    """Resident whole pass, resident windowed retire (output over budget)
    and streaming give the same scores; the resident pass fetches once."""
    u8 = np.random.default_rng(6).integers(
        0, 256, (9, 32 * 32 * 3), dtype=np.uint8)
    frame = Frame.from_dict({"x": u8}, num_partitions=3)
    dp = {"srcShape": [32, 32, 3], "resize": [32, 32]}

    def score(cache):
        model = TorchModel(inputCol="x", outputCol="f", miniBatchSize=2,
                           outputNodeName="pool", devicePreprocess=dp,
                           deviceCache=cache)
        model.set_model("resnet20_cifar", seed=1, **ARCH)
        before = syncs.total()
        out = np.asarray(model.transform(frame).column("f"))
        return out, syncs.total() - before

    resident, fetches = score("auto")
    assert fetches == 1 and residency.stats()["uploads"] == 1
    streamed, _ = score("off")
    # 5 uploaded batches of 2 rows: 30720 B of input, charged 2x, fits a
    # 0.065 MB budget; with the (5, 2, 64) fp32 output beside it (2560 B)
    # it does not, so the pass retires in windows
    residency.clear()
    tconfig.set("runtime.device_cache_mb", 0.065)
    windowed, _ = score("auto")
    assert residency.stats()["uploads"] == 1
    assert resident.shape == (9, 64)
    np.testing.assert_array_equal(resident, streamed)
    np.testing.assert_array_equal(resident, windowed)


def test_streaming_retires_across_windows():
    """More batches than one retire window (32): every row comes back, in
    order, and equals the resident pass."""
    x = np.random.default_rng(7).normal(size=(70, 8 * 8 * 3)).astype(
        np.float32)
    frame = Frame.from_dict({"x": x})
    outs = []
    for cache in ("off", "on"):
        model = TorchModel(inputCol="x", outputCol="f", miniBatchSize=2,
                           deviceCache=cache,
                           devicePreprocess={"srcShape": [8, 8, 3],
                                             "resize": [32, 32]})
        model.set_model("resnet20_cifar", seed=2, **ARCH)
        outs.append(np.asarray(model.transform(frame).column("f")))
    assert outs[0].shape == (70, 10)
    np.testing.assert_array_equal(outs[0], outs[1])


def test_bfloat16_compute_matches_jax_loosely(jparams):
    """computeDtype='bfloat16' casts after the fp32 preprocess in both
    packages; bf16 rounding differs between the frameworks, so the bound
    is 5% of the features' scale (see ``test_torch_resnet.py``)."""
    tfz, got, want = _featurize_both(jparams, _u8_images(8, 4, 32, 32), 1,
                                     computeDtype="bfloat16")
    assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()


def test_bfloat16_features_take_the_kernels_bf16_store_bit_identically(
        jparams, monkeypatch):
    """With computeDtype='bfloat16' the fused preprocess stores bf16 itself
    (no second pass casting its fp32 output). Its store rounds the same fp32
    value the cast rounded, so the features equal, bit for bit, those of
    the route that asks the preprocess for fp32 and casts after it."""
    from mmlspark_tpu_torch.ops import preprocess as tpre
    made = []
    real = tpre.make_fused_preprocess_fn

    def spy(*args, **kw):
        made.append(kw["out_dtype"])
        return real(*args, **kw)

    def f32_then_cast(*args, **kw):
        fn = real(*args, **dict(kw, out_dtype=torch.float32))
        return lambda u8: fn(u8).to(kw["out_dtype"])

    feats = []
    for make in (spy, f32_then_cast):
        monkeypatch.setattr(tpre, "make_fused_preprocess_fn", make)
        tframe, _ = _frames(_u8_images(12, 5, 40, 40))
        fz = ImageFeaturizer(cutOutputLayers=1, miniBatchSize=2,
                             computeDtype="bfloat16")
        fz.set_model("resnet20_cifar", params=jparams, **ARCH)
        feats.append(np.asarray(fz.transform(tframe).column("features")))
    assert made == [torch.bfloat16]
    assert feats[0].shape == (5, 64)
    np.testing.assert_array_equal(feats[0], feats[1])


def test_bfloat16_real_resize_features_match_jax_loosely(jparams):
    """The bf16 store on a real resize (40x40 -> 32x32) against the JAX
    featurizer, which casts after its fp32 preprocess: within the bf16
    bound of ``test_bfloat16_compute_matches_jax_loosely`` (5% of the
    features' scale)."""
    tfz, got, want = _featurize_both(jparams, _u8_images(13, 6, 40, 40), 1,
                                     computeDtype="bfloat16")
    assert tfz._tm_cache.get("devicePreprocess") == {
        "srcShape": [40, 40, 3], "resize": [32, 32]}
    assert got.shape == want.shape == (6, 64)
    assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()


def test_image_featurizer_save_load_round_trip(jparams, tmp_path):
    tframe, _ = _frames(_u8_images(9, 3, 40, 40))
    fz = ImageFeaturizer(cutOutputLayers=1, miniBatchSize=2)
    fz.set_model("resnet20_cifar", params=jparams, **ARCH)
    expected = np.asarray(fz.transform(tframe).column("features"))
    save_stage(fz, str(tmp_path / "fz"))
    loaded = load_stage(str(tmp_path / "fz"))
    assert type(loaded) is ImageFeaturizer
    np.testing.assert_array_equal(
        np.asarray(loaded.transform(tframe).column("features")), expected)
    # the image transformer round-trips too
    it = ImageTransformer().resize(8, 8).center_crop(4, 4)
    save_stage(it, str(tmp_path / "it"))
    assert load_stage(str(tmp_path / "it")).stages == it.stages


def test_unported_options_raise(jparams):
    frame = Frame.from_dict({"x": np.zeros((2, 32 * 32 * 3), np.float32)})
    # a mesh of two ranks needs them: without a process group it raises
    model = TorchModel(inputCol="x", outputCol="f", meshSpec={"data": 2})
    model.set_model("resnet20_cifar", **ARCH)
    with pytest.raises(RuntimeError, match="process group"):
        model.transform(frame)
    # an unnamed submodule's output is captured now, as the reference
    # captures it (NHWC, the reference's name)
    x = np.random.default_rng(12).normal(size=(2, 32 * 32 * 3)).astype(
        np.float32)
    model = TorchModel(inputCol="x", outputCol="f",
                       outputNodeName="stage0_block0/out")
    model.set_model("resnet20_cifar", params=jparams, **ARCH)
    jm = JaxModel(inputCol="x", outputCol="f",
                  outputNodeName="stage0_block0/out")
    jm.set_model("resnet20_cifar", params=jparams, **ARCH)
    got = np.asarray(model.transform(Frame.from_dict({"x": x})).column("f"))
    want = np.asarray(jm.transform(JFrame.from_dict({"x": x})).column("f"))
    assert got.shape == want.shape == (2, 32, 32, 16)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # binary input decodes now (io/codecs.py); bytes no codec reads are
    # refused as the reference refuses them
    tframe, _ = _frames(_u8_images(10, 1, 4, 4))
    binary = tframe.with_column_values(
        ColumnSchema("raw", DType.BINARY),
        np.array([b"\x89PNG"], dtype=object))
    with pytest.raises(SchemaError, match="undecodable"):
        ImageTransformer(inputCol="raw", outputCol="img").transform(binary)


def test_port_state_dict_params_are_accepted_as_is(jparams):
    """set_model takes the port's own flat state dict as well as the JAX
    tree; both score the same."""
    x = np.random.default_rng(11).normal(size=(3, 32 * 32 * 3)).astype(
        np.float32)
    frame = Frame.from_dict({"x": x})
    a = TorchModel(inputCol="x", outputCol="f")
    a.set_model("resnet20_cifar", params=jparams, **ARCH)
    b = TorchModel(inputCol="x", outputCol="f")
    b.set_model("resnet20_cifar", params=a._state["params"], **ARCH)
    np.testing.assert_array_equal(
        np.asarray(a.transform(frame).column("f")),
        np.asarray(b.transform(frame).column("f")))
    assert torch.get_default_dtype() == torch.float32


def test_image_transformer_stages_match_jax():
    """Every host stage of the port's ImageTransformer copy against the JAX
    package's on the same ragged uint8 images, then UnrollImage."""
    from mmlspark_tpu.image.transformer import (
        ImageTransformer as JImageTransformer, UnrollImage as JUnrollImage,
    )
    from mmlspark_tpu_torch.image.transformer import UnrollImage
    rng = np.random.default_rng(12)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in [(20, 30), (17, 17), (20, 30)]]
    tframe, jframe = _frames(images)
    outs = []
    for it_cls, un_cls, frame in ((ImageTransformer, UnrollImage, tframe),
                                  (JImageTransformer, JUnrollImage, jframe)):
        it = (it_cls(inputCol="image", outputCol="img").resize(16, 18)
              .center_crop(12, 14).crop(1, 2, 8, 10).flip()
              .blur(3, 3).gaussian_kernel(5, 0.0).threshold(100, 200)
              .color_format("bgr2rgb").color_format("bgr2gray")
              .color_format("gray2bgr"))
        unrolled = un_cls(inputCol="img", outputCol="v").transform(
            it.transform(frame))
        outs.append(np.asarray(unrolled.column("v")))
    assert outs[0].shape == (3, 8 * 10 * 3)
    np.testing.assert_array_equal(outs[0], outs[1])


def test_sync_points_are_counted_per_site():
    syncs.reset()
    x = torch.arange(6, dtype=torch.bfloat16)
    host = syncs.device_get(x, "test.fetch")
    assert host.dtype == np.float32 and host.tolist() == list(range(6))
    syncs.synchronize("test.wait", device="cpu")
    assert syncs.total() == 2
    assert syncs.counts() == {"test.fetch": 1, "test.wait": 1}
