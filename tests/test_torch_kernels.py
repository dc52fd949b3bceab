"""The port's hand-written CUDA kernels and their wrappers.

This file imports no JAX, so the tests marked ``cuda`` can run on a
machine with a card and without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

Without a card those tests skip (a CUDA kernel has no CPU mode); the
others check, on the CPU, what surrounds the kernels: the wrappers'
refusals, the build's cache key, the reading of ptxas's report and the
byte counts the bounds use.
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.kernels import (
    CROP_RESIZE_NORMALIZE, FLASH_ATTENTION, FLASH_ATTENTION_TC,
    FUSED_NORMALIZE, KERNELS, build,
)
from mmlspark_tpu_torch.ops import attention as tatt
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
                                         "crop_resize_normalize",
                                         "flash_attention",
                                         "flash_attention_tc"]
    for k in KERNELS:
        assert k.source.exists()
        assert k.launches >= 0


# what nvcc -Xptxas=-v prints for two functions, one of which spills
_PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelILi64EEvPf' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi64EEvPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 472 bytes cmem[0]
ptxas info    : Compiling entry function '_Z6kernelILi2048EEvPf' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi2048EEvPf
    176 bytes stack frame, 176 bytes spill stores, 172 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 176 bytes cumulative stack size
"""


def test_ptxas_report_pairs_each_function_with_its_numbers():
    assert build.ptxas_report(_PTXAS_LOG) == {
        "_Z6kernelILi64EEvPf": {"registers": 168, "spill_stores": 0,
                                "spill_loads": 0},
        "_Z6kernelILi2048EEvPf": {"registers": 255, "spill_stores": 176,
                                  "spill_loads": 172}}
    assert build.ptxas_report("") == {}


def test_a_cached_build_keeps_its_ptxas_log(tmp_path, monkeypatch):
    """A library built earlier is a hit, and its nvcc output is read back
    from beside it, so the spill check sees every build."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    k = build.Kernel("k", "flash_attention.cu", [])
    KERNELS.remove(k)
    k.library().write_bytes(b"")
    k.library().with_suffix(".log").write_text(_PTXAS_LOG)
    assert build.build_all([k]) == {"k": "hit"}
    assert build.ptxas_report(k.build_log)["_Z6kernelILi2048EEvPf"][
        "spill_stores"] == 176


def test_k3_variants_replace_only_the_named_tile_configs(monkeypatch):
    """``k3_variants.py`` builds the committed source with some K3_CONFIG
    lines replaced, and refuses a head dim the source has no line for."""
    monkeypatch.syspath_prepend(str(FLASH_ATTENTION.source.parents[3]))
    import k3_variants
    source = FLASH_ATTENTION.source.read_text()
    got = k3_variants.variant_source(
        source, "64:128,16,16,64,1;512:16,4,32,128,1")
    assert "K3_CONFIG(64, 128, 16, 16, 64, 1)" in got
    assert "K3_CONFIG(512, 16, 4, 32, 128, 1)" in got
    assert len(got.splitlines()) == len(source.splitlines())
    changed = [a for a, b in zip(source.splitlines(), got.splitlines())
               if a != b]
    assert all(line.startswith(("K3_CONFIG(64,", "K3_CONFIG(512,"))
               for line in changed)
    with pytest.raises(ValueError, match="D = 96"):
        k3_variants.variant_source(source, "96:64,8,16,64,1")


def test_reset_launches_zeroes_every_count():
    CROP_RESIZE_NORMALIZE.launches = 5
    FUSED_NORMALIZE.launches = 3
    FLASH_ATTENTION.launches = 48
    FLASH_ATTENTION_TC.launches = 48
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


# K3: (B, L, H, D) shapes that supports() admits, from the smallest head dim
# to the D = 2048 corner (L * D = 2**20 at L = 512), and the LM's own shape
K3_SHAPES = [(2, 512, 2, 8), (2, 512, 2, 16), (1, 2048, 2, 64),
             (2, 512, 2, 128), (1, 512, 2, 512), (1, 512, 1, 2048)]


def _qkv(seed, shape, dtype=torch.float32, device="cpu"):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                 .to(device=device, dtype=dtype) for _ in range(3))


K3_F32_TOL = 2e-5
# the tensor-core route (bf16, D <= 128) against the plain version: p
# rounded to bf16 moves each output by at most bf16's unit roundoff 2^-8 of
# max|v|, beyond the fp32 sum order (K3_F32_TOL) and one bf16 step of the
# output; the mean |difference| stays within 2^-8 of the mean |output|
# (a CPU emulation of its arithmetic reads at most 0.50 of the bound and
# 0.38 of the mean ceiling, tests/test_torch_attention.py)
TC_P_ROUNDING, TC_MEAN_CEILING = 2.0 ** -8, 2.0 ** -8


def _bf16_step(g, w):
    mag = torch.maximum(g.abs(), w.abs())
    return torch.where(mag > 0, torch.exp2(torch.floor(torch.log2(mag)) - 7),
                       torch.zeros_like(mag))


def _within_tc_gate(got, want, v):
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    bound = TC_P_ROUNDING * v.float().abs().max() + K3_F32_TOL \
        + _bf16_step(g, w)
    return bool((diff <= bound).all()) \
        and diff.mean().item() <= TC_MEAN_CEILING * w.abs().mean().item()


def _within_one_bf16_ulp(got, want):
    """|got - want| at most one bf16 step of the larger magnitude beyond
    the fp32 disagreement: the kernel and the plain version round to bf16
    fp32 values that differ by up to K3_F32_TOL (the order of their fp32
    sums), and near zero that difference is many bf16 steps of the value."""
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= _bf16_step(g, w) + K3_F32_TOL).all())


def _launches():
    return FLASH_ATTENTION.launches, FLASH_ATTENTION_TC.launches


def test_k3_cpu_tensor_takes_the_plain_version_without_counting():
    before = _launches()
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _qkv(20, (1, 512, 2, 16), dtype)
        for causal in (False, True):
            got = tatt.flash_attention(q, k, v, causal=causal)
            assert torch.equal(got, tatt.flash_attention_plain(q, k, v,
                                                               causal))
    assert _launches() == before


def test_k3_tma_rule_on_views():
    """The tensor-core route reads q, k, v by TMA in place: a 16-byte-
    aligned base and (b, l, h) strides of 16-byte multiples. A fused qkv
    unbind passes; a view one element in, or with a 68-element row, does
    not. A dim of size 1 is passed with its contiguous stride."""
    qkv = torch.zeros((2, 512, 3, 4, 64), dtype=torch.bfloat16)
    assert all(tatt._tma_ready(t) for t in qkv.unbind(dim=2))
    flat = torch.zeros(512 * 2 * 64 + 1, dtype=torch.bfloat16)
    assert not tatt._tma_ready(flat[1:].view(1, 512, 2, 64))
    wide = torch.zeros((1, 512, 2, 68), dtype=torch.bfloat16)[..., :64]
    assert not tatt._tma_ready(wide)
    one = torch.zeros((1, 512, 1, 64), dtype=torch.bfloat16).as_strided(
        (1, 512, 1, 64), (3, 64, 5, 1))
    assert tatt._tma_ready(one)
    assert tatt._strides(one) == [512 * 64, 64, 64]


def test_k3_wrapper_refuses_a_device_without_a_kernel():
    before = _launches()
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.empty((1, 512, 2, 16), dtype=dtype, device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            tatt.flash_attention(q, q, q)
    assert _launches() == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K3_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_matches_plain_on_the_card(card, shape, causal, dtype):
    """K3 against its plain version on the same card tensors, through the
    route ``_route`` names. The CUDA-core route computes in fp32 as the
    plain version does (TF32 off) and differs in the order of its sums, so
    f32 holds to 2e-5 and bf16 (D > 128) to one bf16 step beyond that; the
    tensor-core route (bf16, D <= 128) holds to its own gate."""
    _check_k3_against_plain(*_qkv(21, shape, dtype, card), causal)


# head dims that are no power of two, so the CUDA-core route's tiles carry
# zero padding columns (bf16 at 24 and 72 takes the tensor cores)
K3_ODD_DIMS = [24, 72, 136, 264, 520]


@pytest.mark.cuda
@pytest.mark.parametrize("d", K3_ODD_DIMS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_odd_head_dims_match_plain_on_the_card(card, d, causal, dtype):
    _check_k3_against_plain(*_qkv(26, (1, 512, 2, d), dtype, card), causal)


@pytest.mark.cuda
def test_k3_long_sequence_in_f32_on_the_card(card):
    """64 key tiles of 64, the heaviest causal query tiles first."""
    _check_k3_against_plain(*_qkv(27, (1, 4096, 2, 64), device=card), True)


@pytest.mark.cuda
def test_k3_f32_reads_fused_qkv_views_in_place_on_the_card(card):
    qkv = torch.from_numpy(np.random.default_rng(28).normal(
        size=(2, 512, 3, 4, 64)).astype(np.float32)).to(card)
    q, k, v = qkv.unbind(dim=2)
    assert not q.is_contiguous()
    _check_k3_against_plain(q, k, v, True)


@pytest.mark.cuda
def test_k3_f32_reads_views_off_16_byte_alignment_on_the_card(card):
    """A view one float in: the CUDA-core route reads K and V one element
    at a time instead of 16 bytes, within the same 2e-5."""
    flat = torch.from_numpy(np.random.default_rng(29).normal(
        size=3 * 512 * 2 * 64 + 1).astype(np.float32)).to(card)
    q, k, v = flat[1:].view(3, 1, 512, 2, 64).unbind(dim=0)
    assert k.data_ptr() % 16 != 0
    _check_k3_against_plain(q, k, v, True)


def _check_k3_against_plain(q, k, v, causal):
    """One K3 call against the plain version on the same card tensors: the
    routed kernel launched once and the other never, the output finite, of
    q's dtype and within the route's gate."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = q.dtype
    tc = tatt._route(dtype, q.shape[3]) == "tc"
    before = _launches()
    got = tatt.flash_attention(q, k, v, causal=causal)
    assert _launches() == (before[0] + (not tc), before[1] + tc)
    want = tatt.flash_attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert bool(torch.isfinite(got.float()).all())
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= K3_F32_TOL
    elif tc:
        assert _within_tc_gate(got, want, v)
    else:
        assert _within_one_bf16_ulp(got, want)


# the tensor-core route at every K3_SHAPES head dim it takes, a head dim
# that is no multiple of 16, and one long sequence of the JAX bench's
# longctx length
K3_TC_SHAPES = [s for s in K3_SHAPES if s[3] <= 128] + [(2, 512, 2, 24),
                                                        (1, 8192, 1, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K3_TC_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("causal", [False, True])
def test_k3_tensor_cores_match_plain_on_the_card(card, shape, causal):
    q, k, v = _qkv(24, shape, torch.bfloat16, card)
    before = _launches()
    got = tatt.flash_attention(q, k, v, causal=causal)
    assert _launches() == (before[0], before[1] + 1)
    want = tatt.flash_attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert bool(torch.isfinite(got.float()).all())
    assert _within_tc_gate(got, want, v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,tc", [(torch.bfloat16, 64, True),
                                        (torch.bfloat16, 128, True),
                                        (torch.float32, 64, False),
                                        (torch.bfloat16, 512, False)])
def test_k3_launches_exactly_its_route_on_the_card(card, dtype, d, tc):
    q, k, v = _qkv(25, (1, 512, 2, d), dtype, card)
    before = _launches()
    tatt.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert _launches() == (before[0] + (not tc), before[1] + tc)


@pytest.mark.cuda
def test_k3_reads_strided_views_in_place_on_the_card(card):
    """q, k and v as views of one fused (B, L, 3, H, D) projection: the
    kernel reads them through their strides, no copy."""
    qkv = torch.from_numpy(np.random.default_rng(22).normal(
        size=(2, 512, 3, 4, 64)).astype(np.float32)).to(card, torch.bfloat16)
    q, k, v = qkv.unbind(dim=2)
    assert not q.is_contiguous()
    before = _launches()
    got = tatt.flash_attention(q, k, v, causal=True)
    assert _launches() == (before[0], before[1] + 1)    # the tensor cores
    want = tatt.flash_attention_plain(q, k, v, True)
    torch.cuda.synchronize()
    assert _within_tc_gate(got, want, v)


@pytest.mark.cuda
def test_k3_tensor_cores_refuse_misaligned_views_on_the_card(card):
    """TMA reads 16-byte-aligned rows: a bf16 view one element in, or with
    rows 68 elements apart, raises before any launch is counted."""
    flat = torch.zeros(512 * 2 * 64 + 1, dtype=torch.bfloat16, device=card)
    shifted = flat[1:].view(1, 512, 2, 64)
    wide = torch.zeros((1, 512, 2, 68), dtype=torch.bfloat16,
                       device=card)[..., :64]
    before = _launches()
    for t in (shifted, wide):
        with pytest.raises(ValueError, match="16-byte"):
            tatt.flash_attention(t, t, t, causal=True)
    assert _launches() == before


@pytest.mark.cuda
def test_k3_refuses_what_it_does_not_take_on_the_card(card):
    q, k, v = _qkv(23, (1, 512, 2, 64), device=card)
    before = _launches()
    with pytest.raises(TypeError):
        tatt.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        tatt.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="supports"):
        tatt.flash_attention(q[:, :256], k[:, :256], v[:, :256])
    with pytest.raises(ValueError, match="contiguous"):
        t = q.transpose(1, 3).contiguous().transpose(1, 3)
        tatt.flash_attention(t, t, t)
    with pytest.raises(ValueError, match="shape"):
        tatt.flash_attention(q, k[:, :, :1], v)
    assert _launches() == before
