"""The port's hand-written CUDA kernels and their wrappers.

This file imports no JAX, so the tests marked ``cuda`` can run on a
machine with a card and without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

Without a card those tests skip (a CUDA kernel has no CPU mode); the
others check, on the CPU, what surrounds the kernels: the wrappers'
refusals, the build's cache key and the byte counts the bounds use.
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.kernels import (
    CROP_RESIZE_NORMALIZE, FUSED_NORMALIZE, KERNELS, build,
)
from mmlspark_tpu_torch.ops import preprocess as tpre

MEAN, STD = (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)
CIFAR_MEAN, CIFAR_STD = (125.3, 123.0, 113.9), (63.0, 62.1, 66.7)
# K1 at the shapes the port's paths give it: the CIFAR train step (bf16 and
# f32) and the 224x224 train lane's input, with mean = std = 127.5
K1_SHAPES = [((256, 32 * 32 * 3), torch.bfloat16, CIFAR_MEAN, CIFAR_STD),
             ((256, 32 * 32 * 3), torch.float32, CIFAR_MEAN, CIFAR_STD),
             ((128, 224 * 224 * 3), torch.bfloat16, (127.5,) * 3,
              (127.5,) * 3)]


def _u8(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """No silent fallback: a tensor on a device without a kernel raises
    rather than running the plain version."""
    plan = tpre.CropResizePlan((8, 8, 3), resize=(4, 4))
    before = CROP_RESIZE_NORMALIZE.launches
    with pytest.raises(ValueError, match="no kernel"):
        tpre.crop_resize_normalize(
            torch.empty((1, 8, 8, 3), dtype=torch.uint8, device="meta"), plan)
    assert CROP_RESIZE_NORMALIZE.launches == before


def test_cpu_tensor_takes_the_plain_version_without_counting():
    plan = tpre.CropResizePlan((8, 8, 3), resize=(4, 4), mean=MEAN, std=STD)
    u8 = torch.from_numpy(_u8(1, (2, 8, 8, 3)))
    before = CROP_RESIZE_NORMALIZE.launches
    got = tpre.crop_resize_normalize(u8, plan, torch.bfloat16)
    assert CROP_RESIZE_NORMALIZE.launches == before
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 4, 4, 3)
    torch.testing.assert_close(
        got, tpre._crop_resize_normalize_plain(u8, plan, torch.bfloat16),
        rtol=0, atol=0)


def test_bytes_moved_counts_weighted_source_and_output():
    plan = tpre.CropResizePlan((256, 256, 3), resize=(224, 224),
                               mean=MEAN, std=STD)
    assert plan.bytes_moved(128) == 128 * (256 * 256 * 3 + 224 * 224 * 3 * 4)
    # a crop alone reads only the window: the second tap has no weight
    crop = tpre.CropResizePlan((256, 256, 3), crop=(224, 224))
    assert crop.bytes_moved(1, torch.bfloat16) == 224 * 224 * 3 * (1 + 2)


def test_build_is_keyed_by_source_and_flags(tmp_path, monkeypatch):
    k = build.Kernel("k", "crop_resize_normalize.cu", [])
    KERNELS.remove(k)
    lib = k.library()
    assert lib.parent == build.BUILD_DIR
    assert lib.name.startswith("crop_resize_normalize-") and lib.suffix == ".so"
    src = tmp_path / "x.cu"
    src.write_text("// one\n")
    k.source = src
    first = k.library()
    src.write_text("// two\n")
    assert k.library() != first
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    src.write_text("// one\n")
    assert k.library() != first


def test_every_kernel_is_registered_once_with_a_source():
    assert [k.name for k in KERNELS] == ["fused_normalize",
                                         "crop_resize_normalize"]
    for k in KERNELS:
        assert k.source.exists()
        assert k.launches >= 0


def test_reset_launches_zeroes_every_count():
    CROP_RESIZE_NORMALIZE.launches = 5
    FUSED_NORMALIZE.launches = 3
    build.reset_launches()
    assert all(k.launches == 0 for k in KERNELS)


def _k1_consts(mean, std, device="cpu"):
    return (torch.tensor(mean, dtype=torch.float32, device=device),
            torch.from_numpy(tpre._inv_std(std)).to(device))


def test_k1_wrapper_refuses_meta_and_non_uint8_without_counting():
    """No silent fallback for K1 either: a tensor on a device without a
    kernel, and a tensor of another dtype, raise before any launch."""
    mean, istd = _k1_consts(CIFAR_MEAN, CIFAR_STD)
    before = FUSED_NORMALIZE.launches
    with pytest.raises(ValueError, match="no kernel"):
        tpre.fused_normalize(torch.empty((2, 12), dtype=torch.uint8,
                                         device="meta"), mean, istd)
    with pytest.raises(TypeError, match="uint8"):
        tpre.fused_normalize(torch.zeros((2, 12)), mean, istd)
    with pytest.raises(TypeError, match="out_dtype"):
        tpre.fused_normalize(torch.zeros((2, 12), dtype=torch.uint8), mean,
                             istd, torch.float16)
    assert FUSED_NORMALIZE.launches == before


def test_k1_cpu_tensor_takes_the_plain_version_without_counting():
    mean, istd = _k1_consts(CIFAR_MEAN, CIFAR_STD)
    u8 = torch.from_numpy(_u8(3, (4, 8, 8, 3)))
    before = FUSED_NORMALIZE.launches
    for dt in (torch.bfloat16, torch.float32):
        got = tpre.fused_normalize(u8, mean, istd, dt)
        assert got.dtype == dt and got.shape == u8.shape
        assert torch.equal(got, ((u8.float() - mean) * istd).to(dt))
    flat = tpre.make_preprocess_fn((8, 8, 3), CIFAR_MEAN, CIFAR_STD)(
        u8.reshape(4, -1))
    assert tuple(flat.shape) == (4, 8, 8, 3)
    assert FUSED_NORMALIZE.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("crop,resize", [(None, (224, 224)),
                                         ((240, 240), (224, 224)),
                                         ((224, 224), None),
                                         ((200, 180), (97, 131))])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_the_card(card, crop, resize, out_dtype):
    """The CUDA kernel against its plain version on the same card tensor.
    Both run the same fp32 operations in the same order, so they should
    agree bit for bit; the bound allowed is one uint8 quantum (1/std) and,
    for bf16, one bf16 step of the largest value."""
    u8 = torch.from_numpy(_u8(7, (16, 256, 256, 3))).to(card)
    plan = tpre.CropResizePlan((256, 256, 3), resize=resize, crop=crop,
                               mean=MEAN, std=STD)
    before = CROP_RESIZE_NORMALIZE.launches
    got = tpre.crop_resize_normalize(u8, plan, out_dtype)
    assert CROP_RESIZE_NORMALIZE.launches == before + 1
    want = tpre._crop_resize_normalize_plain(u8, plan, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == want.shape
    diff = (got.float() - want.float()).abs()
    bound = 1.01 / min(STD)
    if out_dtype == torch.bfloat16:
        bound += 2 ** -7 * want.float().abs().max().item()
    assert diff.max().item() <= bound
    assert (diff > 0).float().mean().item() <= 0.01


@pytest.mark.cuda
def test_kernel_refuses_bad_inputs_on_the_card(card):
    plan = tpre.CropResizePlan((8, 8, 3), resize=(4, 4))
    with pytest.raises(TypeError):
        tpre.crop_resize_normalize(
            torch.zeros((1, 8, 8, 3), device=card), plan)
    with pytest.raises(ValueError):
        tpre.crop_resize_normalize(
            torch.zeros((1, 8, 9, 3), dtype=torch.uint8, device=card), plan)
    with pytest.raises(ValueError):
        tpre.crop_resize_normalize(
            torch.zeros((1, 8, 8, 6), dtype=torch.uint8,
                        device=card)[..., :3], plan)
    with pytest.raises(TypeError):
        tpre.crop_resize_normalize(
            torch.zeros((1, 8, 8, 3), dtype=torch.uint8, device=card), plan,
            torch.float16)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,out_dtype,mean,std", K1_SHAPES)
def test_k1_is_bit_equal_to_plain_on_the_card(card, shape, out_dtype, mean,
                                              std):
    """K1 and its plain version run the same two fp32 roundings and the
    same round-to-nearest-even cast: bit-equal (tolerance 0)."""
    u8 = torch.from_numpy(_u8(11, shape)).to(card)
    consts = _k1_consts(mean, std, card)
    before = FUSED_NORMALIZE.launches
    got = tpre.fused_normalize(u8, *consts, out_dtype)
    assert FUSED_NORMALIZE.launches == before + 1
    want = tpre._fused_normalize_plain(u8, *consts, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_k1_misaligned_and_ragged_inputs_on_the_card(card):
    """A view that starts off a 16-byte boundary takes the one-element
    variant, and a length that is not a multiple of 16 ends in the scalar
    tail; both stay bit-equal to the plain version."""
    consts = _k1_consts(CIFAR_MEAN, CIFAR_STD, card)
    base = torch.from_numpy(_u8(12, (3 * 1000 + 3,))).to(card)
    for u8 in (base[3:].reshape(1000, 3), base[:3 * 999].reshape(999, 3)):
        got = tpre.fused_normalize(u8, *consts, torch.float32)
        want = tpre._fused_normalize_plain(u8, *consts, torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="channels"):
        tpre.fused_normalize(base[:10], *consts)
