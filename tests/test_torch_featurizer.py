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
import os
import sys
import threading

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
from mmlspark_tpu_torch.image import featurizer as tfeaturizer
from mmlspark_tpu_torch.image.featurizer import ImageFeaturizer
from mmlspark_tpu_torch.image.transformer import ImageTransformer
from mmlspark_tpu_torch.models import residency
from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.observability import metrics as tmetrics
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


# -- the direct route: one scan, one copy into the reused staging stack --

def _routes():
    """(featurize.direct_stack, featurize.unroll_route) counts so far."""
    return (tmetrics.counter("featurize.direct_stack").value,
            tmetrics.counter("featurize.unroll_route").value)


def _counted(fn):
    """``fn()``'s result and the routes it counted."""
    before = _routes()
    out = fn()
    after = _routes()
    return out, (after[0] - before[0], after[1] - before[1])


def _resident(frame):
    """The one device-resident input uploaded for ``frame``."""
    (dev,) = residency._CACHE[frame].values()
    return dev.numpy()


def _features(fz, frame):
    return np.asarray(fz.transform(frame).column("features"))


def _unroll_route(monkeypatch):
    """Featurizers made in this test take today's route: UnrollImage,
    then TorchModel's own padded stack."""
    monkeypatch.setattr(ImageFeaturizer, "_direct",
                        lambda self, *args: False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_direct_route_is_bit_identical_to_the_unroll_route(
        jparams, monkeypatch, dtype):
    """Seven uint8 images over two partitions, batches of 4 (one pad row):
    the direct route uploads the very bytes the unroll route uploads, and
    the features equal its features bit for bit (and JAX's, as the fused
    tests above bound them)."""
    images = _u8_images(14, 7, 32, 32)
    tframe, jframe = _frames(images)
    fz = ImageFeaturizer(cutOutputLayers=1, miniBatchSize=4,
                         computeDtype=dtype)
    fz.set_model("resnet20_cifar", params=jparams, **ARCH)
    direct, counted = _counted(lambda: _features(fz, tframe))
    assert counted == (1, 0)
    direct_input = _resident(tframe)
    assert tfeaturizer._PREP_CACHE[tframe][("image", (32, 32, 3))][0] is None

    residency.clear()
    tfeaturizer._PREP_CACHE.clear()
    _unroll_route(monkeypatch)
    tframe, _ = _frames(images)
    old = ImageFeaturizer(cutOutputLayers=1, miniBatchSize=4,
                          computeDtype=dtype)
    old.set_model("resnet20_cifar", params=jparams, **ARCH)
    unrolled, counted = _counted(lambda: _features(old, tframe))
    assert counted == (0, 1)
    (unrolled_frame,) = residency._CACHE.keys()
    np.testing.assert_array_equal(direct_input, _resident(unrolled_frame))
    assert direct_input.shape == (2, 4, 32 * 32 * 3)
    np.testing.assert_array_equal(direct, unrolled)
    want = np.asarray(JImageFeaturizer(cutOutputLayers=1, miniBatchSize=4,
                                       computeDtype=dtype)
                      .set_model("resnet20_cifar", params=jparams, **ARCH)
                      .transform(jframe).column("features"))
    bound = 1e-4 if dtype == "float32" else 0.05 * np.abs(want).max()
    assert np.abs(direct - want).max() <= bound


def test_a_smaller_frame_after_a_larger_one_reads_no_stale_rows(
        jparams, monkeypatch):
    """Nine images fill the staging stack's three batches; five after them
    take its first two, and the three pad rows of the second are zero,
    not the larger frame's images."""
    fz = ImageFeaturizer(cutOutputLayers=1, miniBatchSize=4)
    fz.set_model("resnet20_cifar", params=jparams, **ARCH)
    big, _ = _frames(_u8_images(15, 9, 32, 32))
    small_images = _u8_images(16, 5, 32, 32)
    small, _ = _frames(small_images)
    _features(fz, big)
    got = _features(fz, small)
    assert fz._staging().buf.shape == (3, 4, 32 * 32 * 3)
    uploaded = _resident(small).reshape(8, -1)
    np.testing.assert_array_equal(
        uploaded[:5], np.stack(small_images).reshape(5, -1))
    assert not uploaded[5:].any()

    _unroll_route(monkeypatch)
    small, _ = _frames(small_images)
    old = ImageFeaturizer(cutOutputLayers=1, miniBatchSize=4)
    old.set_model("resnet20_cifar", params=jparams, **ARCH)
    np.testing.assert_array_equal(got, _features(old, small))


def test_the_staging_stack_is_reused_across_fresh_frames(jparams):
    """Two fresh frames of one shape are gathered into one buffer; the
    memo keeps no unrolled host copy of either."""
    fz = ImageFeaturizer(cutOutputLayers=1, miniBatchSize=4)
    fz.set_model("resnet20_cifar", params=jparams, **ARCH)
    bufs = []
    for seed in (17, 18):
        frame, _ = _frames(_u8_images(seed, 6, 32, 32))
        _, counted = _counted(lambda: _features(fz, frame))
        assert counted == (1, 0)
        bufs.append(fz._staging().buf)
        (memo,) = tfeaturizer._PREP_CACHE[frame].values()
        assert memo[0] is None
    assert bufs[0] is bufs[1] and np.shares_memory(bufs[0], bufs[1])
    # the host device's resident input is a copy: the next gather may not
    # write into an upload another model still reads
    assert not np.shares_memory(_resident(frame), bufs[1])


def test_a_memo_hit_whose_upload_was_evicted_gathers_the_frame_again(
        jparams):
    """The direct route's memo holds no host copy: when the frame's upload
    is gone, a repeat pass counts no route and skips the prep, and the
    hand-over gathers the frame again into the staging stack."""
    fz = ImageFeaturizer(cutOutputLayers=1, miniBatchSize=4)
    fz.set_model("resnet20_cifar", params=jparams, **ARCH)
    frame, _ = _frames(_u8_images(19, 6, 32, 32))
    first = _features(fz, frame)
    # another model's upload of another frame evicts this frame's
    other = TorchModel(inputCol="x", outputCol="y").set_model(
        "mlp_tabular", input_dim=8, hidden=[16], num_classes=3)
    other.transform(Frame.from_dict({"x": np.ones((3, 8), np.float32)}))
    assert frame not in residency._CACHE
    again, counted = _counted(lambda: _features(fz, frame))
    assert counted == (0, 0) and frame in residency._CACHE
    np.testing.assert_array_equal(first, again)


def test_threads_featurize_their_own_frames_on_one_featurizer(jparams):
    """More threads than cores, each with a frame of its own, featurize in
    turn on one featurizer, every call a fresh frame (each evicts the
    others' memo and upload): every call's features equal the serial
    answer for its images, so no thread read another's images from the
    shared staging stack."""
    fz = ImageFeaturizer(cutOutputLayers=1, miniBatchSize=4)
    fz.set_model("resnet20_cifar", params=jparams, **ARCH)
    n = min((os.cpu_count() or 4) + 1, 17)
    images = {t: _u8_images(30 + t, 5, 32, 32) for t in range(n)}
    want = {t: _features(fz, _frames(images[t])[0]) for t in range(n)}
    got = {t: [] for t in range(n)}

    def work(t):
        for _ in range(2):
            got[t].append(_features(fz, _frames(images[t])[0]))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    for t in range(n):
        assert len(got[t]) == 2
        for feats in got[t]:
            np.testing.assert_array_equal(feats, want[t])


def test_two_image_columns_of_one_frame_each_get_their_own_features(
        jparams, monkeypatch):
    """One frame with two uint8 image columns of one shape, featurized in
    turn by one featurizer and then by a second: each column's features
    are those the unroll route gives for that column, so neither upload
    was taken for the other's."""
    tframe, _ = _frames(_u8_images(24, 6, 32, 32))
    thumbs = np.empty(6, dtype=object)
    for i, im in enumerate(_u8_images(25, 6, 32, 32)):
        thumbs[i] = ImageValue(path=f"mem://t{i}", data=im)
    tframe = tframe.with_column_values(ColumnSchema("thumb", DType.IMAGE),
                                       thumbs)
    fz = ImageFeaturizer(cutOutputLayers=1, miniBatchSize=4)
    fz.set_model("resnet20_cifar", params=jparams, **ARCH)
    got = {}
    for col in ("image", "thumb"):
        fz.set_params(inputCol=col)
        got[col], counted = _counted(lambda: _features(fz, tframe))
        assert counted == (1, 0)
    other = ImageFeaturizer(cutOutputLayers=1, miniBatchSize=4,
                            inputCol="thumb")
    other.set_model("resnet20_cifar", params=jparams, **ARCH)
    again, counted = _counted(lambda: _features(other, tframe))
    assert counted == (0, 0)  # the memo of the first featurizer's pass
    np.testing.assert_array_equal(again, got["thumb"])

    residency.clear()
    tfeaturizer._PREP_CACHE.clear()
    _unroll_route(monkeypatch)
    old = ImageFeaturizer(cutOutputLayers=1, miniBatchSize=4)
    old.set_model("resnet20_cifar", params=jparams, **ARCH)
    for col in ("image", "thumb"):
        old.set_params(inputCol=col)
        np.testing.assert_array_equal(got[col], _features(old, tframe))
    assert np.abs(got["image"] - got["thumb"]).max() > 0


def test_the_stack_is_held_only_from_the_gather_to_the_upload(
        jparams, monkeypatch):
    """The staging stack's lock is free while the frame is scored from
    its upload, and a repeat pass whose upload is resident never waits
    for it; a copy of the featurizer has a stack of its own."""
    fz = ImageFeaturizer(cutOutputLayers=1, miniBatchSize=4)
    fz.set_model("resnet20_cifar", params=jparams, **ARCH)
    frame, _ = _frames(_u8_images(26, 6, 32, 32))
    scoring = TorchModel._transform_resident
    held = []

    def spy(self, *args):
        held.append(fz._staging().lock.locked())
        return scoring(self, *args)

    monkeypatch.setattr(TorchModel, "_transform_resident", spy)
    first = _features(fz, frame)
    assert held == [False]

    done = []
    with fz._staging().lock:
        th = threading.Thread(target=lambda: done.append(
            _features(fz, frame)))
        th.start()
        th.join(timeout=60)
        assert not th.is_alive()
    np.testing.assert_array_equal(done[0], first)
    assert len(held) == 2  # scored while the test held the stack
    assert fz.copy()._staging() is not fz._staging()


def _route_case(case):
    """(frame, setup(featurizer)) of one route-choice case."""
    rng = np.random.default_rng(21)
    if case == "ragged":
        images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                  for h, w in [(20, 30), (32, 32), (41, 17)]]
    elif case == "float":
        images = list(rng.uniform(0, 255, (5, 32, 32, 3)).astype(np.float32))
    else:
        images = _u8_images(22, 5, 32, 32)
    frame, _ = _frames(images)

    def setup(fz):
        if case == "device_cache_off":
            # the scoring model of this shape, then deviceCache off on it
            _features(fz, _frames(_u8_images(23, 2, 32, 32))[0])
            fz._tm_cache.set_params(deviceCache="off")
        elif case == "over_budget":
            # 2 x (2, 4, 3072) B of uint8 stack is over 0.01 MB
            tconfig.set("runtime.device_cache_mb", 0.01)
    return frame, setup


@pytest.mark.parametrize("case,routes", [
    ("fused", (1, 0)), ("ragged", (0, 1)), ("float", (0, 1)),
    ("device_cache_off", (0, 1)), ("over_budget", (0, 1))])
def test_the_route_is_chosen_from_the_input_and_counted(
        jparams, case, routes):
    """Only the fused case that can stay resident takes the direct route;
    each fresh frame counts its route once, and a memo hit counts
    neither and gives the same features."""
    fz = ImageFeaturizer(cutOutputLayers=1, miniBatchSize=4)
    fz.set_model("resnet20_cifar", params=jparams, **ARCH)
    frame, setup = _route_case(case)
    setup(fz)
    first, counted = _counted(lambda: _features(fz, frame))
    assert counted == routes
    again, counted = _counted(lambda: _features(fz, frame))
    assert counted == (0, 0)
    np.testing.assert_array_equal(first, again)
