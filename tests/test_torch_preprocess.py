"""Parity of the port's image preprocess (``mmlspark_tpu_torch.ops.preprocess``)
with the JAX package's (``mmlspark_tpu.ops.pallas_preprocess``).

The JAX side runs as its own tests run it: the Pallas kernel in interpret
mode on the CPU. The port's side runs the plain torch version of its CUDA
kernel, which is what a CPU tensor takes. Inputs come from numpy seeds.

Tolerance of the crop-resize cases: the two sides sum the bilinear taps in
a different fp32 order (two matmuls against a direct lerp), so a value
that lands within rounding of a .5 tie can requantize to the neighbouring
uint8 level. One level is ``1 / std`` after normalization: the bound is
``1.01 / min(std)`` absolute, on at most 1% of elements. A crop alone
resamples nothing and must agree to float error (2e-5).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.ops import pallas_preprocess as jpre
from mmlspark_tpu_torch.ops import preprocess as tpre
from mmlspark_tpu_torch.utils import config as tconfig

MEAN, STD = (125.3, 123.0, 113.9), (63.0, 62.1, 66.7)


@pytest.fixture(autouse=True)
def _cpu_device():
    tconfig.set("runtime.device", "cpu")
    yield
    tconfig.unset("runtime.device")


def _u8(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _assert_within_one_quantum(got, want, std):
    tol = 1.01 / min(np.broadcast_to(np.asarray(std, np.float32), (3,)))
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert diff.max() <= tol, diff.max()
    assert (diff > 1e-4).mean() <= 0.01, (diff > 1e-4).mean()


@pytest.mark.parametrize("src,dst,crop_off,crop_size", [
    (48, 28, 6.0, 36), (40, 24, 4.0, 32), (256, 224, 0.0, None),
    (256, 224, 16.0, 224), (64, 96, 0.0, None), (7, 7, 0.0, None),
    (5, 13, 1.0, 3),
])
def test_sampling_matrix_bit_equal(src, dst, crop_off, crop_size):
    want = jpre._sampling_matrix(src, dst, crop_off, crop_size)
    got = tpre._sampling_matrix(src, dst, crop_off, crop_size)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("case", [
    dict(name="resize", src=(40, 48, 3), resize=(24, 28), crop=None),
    dict(name="crop_resize", src=(40, 48, 3), resize=(24, 28), crop=(32, 36)),
    dict(name="upscale", src=(16, 20, 3), resize=(24, 30), crop=None),
    dict(name="main_shape", src=(256, 256, 3), resize=(224, 224), crop=None),
])
def test_fused_preprocess_matches_jax(case):
    b = 2 if case["name"] == "main_shape" else 5
    u8 = _u8(1, (b,) + case["src"])
    kw = dict(resize=case["resize"], crop=case["crop"], mean=MEAN, std=STD)
    want = np.asarray(jpre.make_fused_preprocess_fn(case["src"], **kw)(
        jnp.asarray(u8.reshape(b, -1))))
    got = tpre.make_fused_preprocess_fn(case["src"], **kw)(
        torch.from_numpy(u8.reshape(b, -1)))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape
    _assert_within_one_quantum(got.numpy(), want, STD)


@pytest.mark.parametrize("crop,resize", [((32, 36), None), (None, None),
                                         ((40, 48), (40, 48))])
def test_crop_only_and_identity_are_exact(crop, resize):
    u8 = _u8(2, (5, 40, 48, 3))
    kw = dict(crop=crop, resize=resize, mean=MEAN, std=STD)
    want = np.asarray(jpre.make_fused_preprocess_fn((40, 48, 3), **kw)(
        jnp.asarray(u8.reshape(5, -1))))
    got = tpre.make_fused_preprocess_fn((40, 48, 3), **kw)(
        torch.from_numpy(u8)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_scalar_and_per_channel_normalization():
    u8 = _u8(3, (4, 12, 10, 3))
    for mean, std in [((0.0,), (1.0,)), ((127.5,), (127.5,)),
                      ((1.0, 2.0, 3.0), (2.0, 4.0, 8.0))]:
        kw = dict(resize=(9, 7), mean=mean, std=std)
        want = np.asarray(jpre.make_fused_preprocess_fn((12, 10, 3), **kw)(
            jnp.asarray(u8.reshape(4, -1))))
        got = tpre.make_fused_preprocess_fn((12, 10, 3), **kw)(
            torch.from_numpy(u8.reshape(4, -1))).numpy()
        _assert_within_one_quantum(got, want, std)


def test_bfloat16_output_matches_jax():
    """bf16 out: both sides normalize in fp32 and round once to bf16; a
    value one quantum apart may round to a bf16 neighbour, so the bound is
    one quantum plus one bf16 step (2^-7 relative) of the largest value."""
    u8 = _u8(4, (3, 20, 24, 3))
    kw = dict(resize=(16, 16), mean=MEAN, std=STD)
    want = np.asarray(jpre.make_fused_preprocess_fn(
        (20, 24, 3), out_dtype=jnp.bfloat16, **kw)(
            jnp.asarray(u8.reshape(3, -1))).astype(jnp.float32))
    got = tpre.make_fused_preprocess_fn(
        (20, 24, 3), out_dtype=torch.bfloat16, **kw)(torch.from_numpy(u8))
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    assert diff.max() <= 1.01 / min(STD) + np.abs(want).max() * 2 ** -7


def test_oversize_crop_raises():
    with pytest.raises(ValueError):
        tpre.make_fused_preprocess_fn((8, 8, 3), crop=(9, 9))


def test_plain_version_is_the_two_tap_lerp():
    """The plain version against a numpy 2-tap lerp written out here from
    the sampling matrix: the same function, by rows of the matrix."""
    u8 = _u8(5, (2, 11, 13, 3))
    plan = tpre.CropResizePlan((11, 13, 3), resize=(7, 9), crop=(9, 11),
                               mean=MEAN, std=STD)
    ry = tpre._sampling_matrix(11, 7, 1.0, 9)
    rx = tpre._sampling_matrix(13, 9, 1.0, 11)
    z = np.einsum("yh,bhwc,xw->byxc", ry.astype(np.float64),
                  u8.astype(np.float64), rx.astype(np.float64))
    want = (np.clip(np.rint(z), 0, 255) - np.asarray(MEAN)) / np.asarray(STD)
    got = tpre._crop_resize_normalize_plain(torch.from_numpy(u8), plan)
    _assert_within_one_quantum(got.numpy(), want, STD)


def test_device_resize_bilinear_matches_jax():
    x = np.random.default_rng(6).normal(size=(3, 17, 23, 3)).astype(np.float32)
    for h, w in [(8, 8), (31, 12), (17, 23)]:
        want = np.asarray(jpre.device_resize_bilinear(jnp.asarray(x), h, w))
        got = tpre.device_resize_bilinear(torch.from_numpy(x), h, w).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
