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


def test_preprocess_variants_replace_only_the_named_constants(monkeypatch):
    """``preprocess_variants.py`` builds K1's or K2's committed source with
    some ``constexpr int`` lines replaced, keeps the Python-side settings
    apart, and refuses a constant the source does not have."""
    monkeypatch.syspath_prepend(str(FUSED_NORMALIZE.source.parents[3]))
    import preprocess_variants
    source = FUSED_NORMALIZE.source.read_text()
    got, settings = preprocess_variants.variant_source(
        source, "kWaves:2,kGroups:8")
    assert "constexpr int kWaves = 2;" in got
    assert "constexpr int kGroups = 8;" in got
    assert settings == {}
    changed = [a for a, b in zip(source.splitlines(), got.splitlines())
               if a != b]
    assert len(changed) == 2 and len(got.splitlines()) == len(
        source.splitlines())
    k2 = CROP_RESIZE_NORMALIZE.source.read_text()
    got, settings = preprocess_variants.variant_source(
        k2, "kThreads:256,band_rows:16")
    assert "constexpr int kThreads = 256;" in got
    assert settings == {"band_rows": "16"}
    with pytest.raises(ValueError, match="kNothing"):
        preprocess_variants.variant_source(k2, "kNothing:1")


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


# K2's geometries beyond the main path: (src (Hs, Ws, C), crop, resize).
# Upscaling, heavy downscaling, crop 240 -> 224, crop only, C = 1 and 4
# (and 2, which takes the kernel's any-C instantiation), and sources whose
# rows (Ws * C bytes) are no multiple of 16, with an
# output row whose bytes are no multiple of 16 among them (97 x 3)
K2_GEOMETRIES = {
    "main": ((256, 256, 3), None, (224, 224)),
    "upscale": ((32, 32, 3), None, (224, 224)),
    "down_1024_32": ((1024, 1024, 3), None, (32, 32)),
    "crop240": ((256, 256, 3), (240, 240), (224, 224)),
    "crop_only": ((256, 256, 3), (224, 224), None),
    "c1": ((64, 64, 1), None, (33, 31)),
    "c4": ((64, 48, 4), (60, 44), (100, 50)),
    "c2": ((64, 64, 2), None, (30, 50)),
    "odd_width": ((37, 41, 3), None, (20, 30)),
    "odd_c1": ((50, 45, 1), (40, 40), (97, 131)),
    "ragged_row": ((200, 192, 3), None, (97, 131)),
}


def _k2_plan(name, **kw):
    src, crop, resize = K2_GEOMETRIES[name]
    mean = MEAN[:src[2]] if src[2] == 3 else (127.5,) * src[2]
    std = STD[:src[2]] if src[2] == 3 else (60.0,) * src[2]
    return tpre.CropResizePlan(src, resize=resize, crop=crop, mean=mean,
                               std=std, **kw)


@pytest.mark.parametrize("name", sorted(K2_GEOMETRIES))
def test_k2_bands_stage_every_tap_within_the_budget(name):
    """Every output row's two source rows sit in its band's staged rows
    (sorted, counted by ``stage_n``), and a staged plan fits its budget at
    the largest band height that does; a direct plan is one whose rows are
    no multiple of 16 bytes or whose one-row bands do not fit."""
    plan = _k2_plan(name)
    (hs, ws, c), (hd, _) = plan.src_shape, plan.dst_hw
    y0, y1, _ = plan.y
    assert 1 <= plan.band_rows <= tpre.K2_BAND_ROWS
    bands = -(-hd // plan.band_rows)
    assert plan.stage_rows.shape == (bands, plan.stage_max)
    assert plan.stage_n.max() == plan.stage_max
    for band in range(bands):
        n = plan.stage_n[band]
        staged = plan.stage_rows[band, :n]
        assert np.all(np.diff(staged) > 0) and staged.min() >= 0 \
            and staged.max() < hs
        ys = range(band * plan.band_rows, min(hd, (band + 1) *
                                              plan.band_rows))
        for y in ys:
            assert 0 <= plan.slots[y].max() < n
            assert staged[plan.slots[y, 0]] == y0[y]
            assert staged[plan.slots[y, 1]] == y1[y]
        # nothing staged that the band's taps do not name
        assert set(staged) == set(y0[list(ys)]) | set(y1[list(ys)])
    rows_ok = ws * c % 16 == 0
    if plan.staged:
        assert rows_ok
        assert plan.smem_bytes(plan.stage_max) <= tpre.K2_SMEM_BUDGET
        if plan.band_rows < min(tpre.K2_BAND_ROWS, hd):
            taller = max(b.size for b in plan._bands(plan.band_rows + 1))
            assert plan.smem_bytes(taller) > tpre.K2_SMEM_BUDGET
    else:
        one_row = max(b.size for b in plan._bands(1))
        assert not rows_ok \
            or plan.smem_bytes(one_row) > tpre.K2_SMEM_BUDGET
    assert plan.staged == (name not in ("odd_width", "odd_c1"))


def test_k2_takes_the_direct_variant_exactly_when_the_plan_says_so():
    """A staging plan takes the staged variant for a source on 16 bytes and
    the direct one for a view off it; a plan that cannot stage (rows no
    multiple of 16 bytes, or a budget below two rows) always goes direct."""
    plan = _k2_plan("main")
    assert plan.staged
    for ptr in range(4096, 4096 + 48):
        assert plan.variant(ptr) == ("staged" if ptr % 16 == 0
                                     else "direct")
    for direct in (_k2_plan("odd_width"),
                   _k2_plan("main", smem_budget=2 * 768)):
        assert not direct.staged
        assert {direct.variant(p) for p in range(4096, 4096 + 48)} == {
            "direct"}
    just = _k2_plan("main", smem_budget=_k2_plan("main").smem_bytes(2))
    assert just.staged and just.band_rows == 1 and just.stage_max == 2


@pytest.mark.parametrize("name", sorted(K2_GEOMETRIES))
def test_k2_staged_rows_reproduce_the_plain_version(name):
    """The staged variant's arithmetic on its tables, in numpy fp32: each
    band gathers its staged rows, each row lerps the two its slots name,
    in the kernel's order. Bit-equal to the plain version."""
    plan = _k2_plan(name)
    (hs, ws, c), (hd, wd) = plan.src_shape, plan.dst_hw
    u8 = _u8(21, (2, hs, ws, c))
    (_, _, fy), (x0, x1, fx) = plan.y, plan.x
    one = np.float32(1)
    out = np.empty((2, hd, wd, c), np.float32)
    for band in range(plan.stage_rows.shape[0]):
        staged = u8[:, plan.stage_rows[band, :plan.stage_n[band]]]
        staged = staged.astype(np.float32)
        for y in range(band * plan.band_rows,
                       min(hd, (band + 1) * plan.band_rows)):
            r0, r1 = staged[:, plan.slots[y, 0]], staged[:, plan.slots[y, 1]]
            wy1 = fy[y]
            wy0 = one - wy1
            left = r0[:, x0] * wy0 + r1[:, x0] * wy1
            right = r0[:, x1] * wy0 + r1[:, x1] * wy1
            wx1 = fx[:, None]
            z = left * (one - wx1) + right * wx1
            z = np.clip(np.rint(z), 0, 255)
            out[:, y] = (z - plan.mean) * plan.istd
    want = tpre._crop_resize_normalize_plain(torch.from_numpy(u8), plan)
    np.testing.assert_array_equal(out, want.numpy())


def test_k1_variant_follows_the_input_alignment():
    assert [tpre._k1_variant(p) for p in (0, 16, 4096)] == ["vector"] * 3
    assert {tpre._k1_variant(p) for p in range(4097, 4112)} == {"scalar"}


def test_variant_launches_are_reset_with_the_counts():
    CROP_RESIZE_NORMALIZE.variant_launches["staged"] = 2
    FUSED_NORMALIZE.variant_launches["scalar"] = 1
    build.reset_launches()
    assert all(not k.variant_launches for k in KERNELS)


def _k2_gate(got, want, std):
    """K2 against its plain version: one uint8 quantum (1/std) and, in
    bf16, one bf16 step of the largest value, on at most 1% of elements.
    Returns (max |diff|, share differing)."""
    diff = (got.float() - want.float()).abs()
    bound = 1.01 / min(std)
    if got.dtype == torch.bfloat16:
        bound += 2 ** -7 * want.float().abs().max().item()
    max_err, share = diff.max().item(), (diff > 0).float().mean().item()
    assert max_err <= bound and share <= 0.01, (max_err, share)
    return max_err, share


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(K2_GEOMETRIES))
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_k2_geometries_match_plain_on_the_card(card, name, out_dtype,
                                               record_testsuite_property):
    """K2 at each geometry, through the variant its plan names (counted),
    against its plain version under the gate of
    ``test_kernel_matches_plain_on_the_card``; the share of elements that
    differ at all, and the largest difference, are recorded as properties
    of the test suite (``--junitxml``)."""
    plan = _k2_plan(name)
    u8 = torch.from_numpy(_u8(22, (6,) + plan.src_shape)).to(card)
    variant = plan.variant(u8.data_ptr())
    assert variant == ("staged" if plan.staged else "direct")
    build.reset_launches()
    got = tpre.crop_resize_normalize(u8, plan, out_dtype)
    assert CROP_RESIZE_NORMALIZE.variant_launches == {variant: 1}
    want = tpre._crop_resize_normalize_plain(u8, plan, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == want.shape
    std = plan.mean.size * [float(1 / plan.istd.max())]
    max_err, share = _k2_gate(got, want, std)
    dt = str(out_dtype).replace("torch.", "")
    record_testsuite_property(f"k2_share_differing[{name}-{dt}]", share)
    record_testsuite_property(f"k2_max_abs_err[{name}-{dt}]", max_err)
    if not plan.y[2].any() and not plan.x[2].any():    # a crop alone
        assert max_err <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 3, 8, 15])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_k2_views_off_alignment_take_the_direct_variant_on_the_card(
        card, offset, out_dtype):
    """A contiguous view 1-15 bytes past a 16-byte boundary runs the
    direct-load variant and holds the same gate; the aligned source runs
    the staged one and gives the same output."""
    plan = _k2_plan("main")
    n = 4 * 256 * 256 * 3
    base = torch.from_numpy(_u8(23, (n + 16,))).to(card)
    view = base[offset:offset + n].view(4, 256, 256, 3)
    build.reset_launches()
    got = tpre.crop_resize_normalize(view, plan, out_dtype)
    aligned = tpre.crop_resize_normalize(view.clone(), plan, out_dtype)
    assert CROP_RESIZE_NORMALIZE.variant_launches == {"direct": 1,
                                                      "staged": 1}
    want = tpre._crop_resize_normalize_plain(view, plan, out_dtype)
    torch.cuda.synchronize()
    _k2_gate(got, want, STD)
    assert torch.equal(got, aligned)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_k2_staged_and_direct_variants_agree_on_the_card(card, out_dtype):
    """The main shape through each variant (a zero budget forces the
    direct one): the same lerps in the same order, so the same bits."""
    staged, direct = _k2_plan("main"), _k2_plan("main", smem_budget=0)
    assert staged.staged and not direct.staged
    u8 = torch.from_numpy(_u8(24, (8, 256, 256, 3))).to(card)
    build.reset_launches()
    a = tpre.crop_resize_normalize(u8, staged, out_dtype)
    b = tpre.crop_resize_normalize(u8, direct, out_dtype)
    torch.cuda.synchronize()
    assert CROP_RESIZE_NORMALIZE.variant_launches == {"staged": 1,
                                                      "direct": 1}
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3, 4, 5])
@pytest.mark.parametrize("n", [16 * 60 + 7, 256 * 3072, 1024 * 150528 + 5])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_k1_channel_phase_and_grid_stride_on_the_card(card, c, n, out_dtype):
    """K1's vector variant keeps each thread on one channel phase and walks
    inputs larger than one wave: bit-equal at C = 1, 3, 4 and 5, from a
    short ragged input to one of several passes (154 MB), each a launch of
    the vector variant."""
    n -= n % c
    rng = np.random.default_rng(25)
    mean = tuple(rng.uniform(0, 255, c).tolist())
    std = tuple(rng.uniform(20, 80, c).tolist())
    consts = _k1_consts(mean, std, card)
    u8 = torch.randint(0, 256, (n,), dtype=torch.uint8, device=card,
                       generator=torch.Generator(card).manual_seed(c))
    build.reset_launches()
    got = tpre.fused_normalize(u8, *consts, out_dtype)
    assert FUSED_NORMALIZE.variant_launches == {"vector": 1}
    want = tpre._fused_normalize_plain(u8, *consts, out_dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 7, 15])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_k1_views_off_alignment_take_the_scalar_variant_on_the_card(
        card, offset, out_dtype):
    consts = _k1_consts(CIFAR_MEAN, CIFAR_STD, card)
    base = torch.from_numpy(_u8(26, (256 * 3072 + 16,))).to(card)
    u8 = base[offset:offset + 256 * 3072].view(256, 3072)
    build.reset_launches()
    got = tpre.fused_normalize(u8, *consts, out_dtype)
    assert FUSED_NORMALIZE.variant_launches == {"scalar": 1}
    want = tpre._fused_normalize_plain(u8, *consts, out_dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_launch_floor_entry_points_run_uncounted_on_the_card(card):
    """The empty kernels chip_smoke.py times as K1's and K2's launch floor
    launch on their kernel's grid and count no launch."""
    from ctypes import c_int, c_longlong, c_void_p
    stream = torch.cuda.current_stream(card).cuda_stream
    build.reset_launches()
    k1 = FUSED_NORMALIZE.symbol("fused_normalize_empty",
                                [c_longlong, c_int, c_int, c_void_p])
    k2 = CROP_RESIZE_NORMALIZE.symbol("crop_resize_normalize_empty",
                                      [c_int, c_int, c_int, c_void_p])
    assert k1(256 * 3072, 3, 1, stream) == 0
    assert k2(128, 224, 8, stream) == 0
    torch.cuda.synchronize()
    assert all(k.launches == 0 and not k.variant_launches for k in KERNELS)

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
