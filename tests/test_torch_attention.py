"""Parity of the port's attention (``mmlspark_tpu_torch.ops.attention``,
``mmlspark_tpu_torch.parallel.sequence``) with the JAX package's.

Inputs come from numpy seeds and go through both packages on the CPU. The
JAX flash kernel runs as its own tests run it there, in Pallas interpret
mode; the port's ``flash_attention`` on a CPU tensor runs its plain
version, the same algorithm. Tolerances:

- the reference path in fp32: the same operations in another summation
  order, 1e-5; in bf16, ``tests/test_sequence.py``'s 4e-2 (both round the
  probabilities to bf16 before the second product, at other places);
- the plain flash version against the interpreted kernel: the same block
  loop in fp32, rtol 1e-5 (with an atol of 1e-6 for outputs near zero at
  D <= 64, and of 2e-5, the f32 route's gate, at D >= 256);
- gradients of the ported backward against ``jax.grad`` of the JAX
  kernel's custom VJP: the same two blockwise passes in fp32, 1e-5
  (measured: 8e-7 at gradients of magnitude up to 3) where
  ``tests/test_sequence.py`` holds the flash gradient to the reference
  path's at 3e-2;
- the tensor-core route's arithmetic (bf16 q.k summed in fp32, exp2 with
  the scale folded into the score, an online max per key tile, p rounded
  to bf16 before p.v), emulated here in plain torch, against the plain
  version and the interpreted kernel: each p_j is off by at most bf16's
  unit roundoff 2^-8 of itself, so ``|dO| <= 2^-8 max|v|``, plus the fp32
  sum-order tolerance 2e-5 and one bf16 step of the output; and the mean
  ``|dO|`` at most 2^-8 of the mean ``|O|`` (this rehearsal reads
  0.0013-0.0015 of it at L = 512). ``chip_smoke.py`` and the card tests
  hold the kernel itself to the same gate.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.ops import pallas_attention as jatt
from mmlspark_tpu.parallel import sequence as jseq
from mmlspark_tpu_torch.kernels import FLASH_ATTENTION, FLASH_ATTENTION_TC
from mmlspark_tpu_torch.ops import attention as tatt
from mmlspark_tpu_torch.parallel import sequence as tseq


def _qkv(seed, shape, n=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def _torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
def test_reference_path_matches_jax_in_float32(causal):
    q, k, v = _qkv(0, (2, 48, 3, 16))
    want = np.asarray(jseq.full_attention(*map(jnp.asarray, (q, k, v)),
                                          causal, use_flash="never"))
    got = tseq.full_attention(*_torch(q, k, v), causal, use_flash="never")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_reference_path_matches_jax_in_bfloat16():
    q, k, v = _qkv(1, (2, 64, 2, 32))
    want = np.asarray(jseq.full_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), True,
        use_flash="never")).astype(np.float32)
    got = tseq.full_attention(*_torch(q, k, v, dtype=torch.bfloat16), True,
                              use_flash="never")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=4e-2,
                               rtol=4e-2)


@pytest.mark.parametrize("shape", [(2, 512, 2, 16), (2, 512, 2, 64),
                                   (1, 512, 2, 256), (1, 512, 1, 512)],
                         ids=lambda s: f"d{s[3]}")
@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_matches_the_interpreted_jax_kernel(causal, shape):
    """At D <= 64, rtol 1e-5 with an atol of 1e-6 for outputs near zero. At
    D >= 256 a score sums more terms and rounds more (1.3e-6 read at
    D = 512, causal), so those cases take the f32 route's own gate, 2e-5."""
    q, k, v = _qkv(2, shape)
    want = np.asarray(jatt.flash_attention(*map(jnp.asarray, (q, k, v)),
                                           causal=causal))
    got = tatt.flash_attention_plain(*_torch(q, k, v), causal)
    atol = 1e-6 if shape[3] <= 64 else 2e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("shape", [(2, 512, 4, 64), (1, 1024, 8, 128),
                                   (2, 197, 4, 64), (2, 256, 4, 64),
                                   (2, 512, 4, 63), (1, 512, 1, 2048),
                                   (1, 512, 1, 2056)])
def test_supports_gate_is_the_jax_packages(shape):
    assert tatt.supports(shape) == jatt.supports(shape)


def test_supports_gate_cases():
    """``tests/test_sequence.py``'s cases."""
    assert tatt.supports((2, 512, 4, 64))
    assert tatt.supports((1, 1024, 8, 128))
    assert not tatt.supports((2, 197, 4, 64))    # ragged
    assert not tatt.supports((2, 256, 4, 64))    # < 2 blocks
    assert not tatt.supports((2, 512, 4, 63))    # head dim not a multiple of 8


@pytest.mark.parametrize("causal", [False, True])
def test_gradients_match_jax_grad_of_the_flash_kernel(causal):
    q, k, v, w = _qkv(3, (1, 512, 2, 32), n=4)

    def jloss(q, k, v):
        return (jatt.flash_attention(q, k, v, causal=causal)
                * jnp.asarray(w)).sum()
    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (t.requires_grad_() for t in _torch(q, k, v))
    (tatt.flash_attention(tq, tk, tv, causal=causal)
     * torch.from_numpy(w)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)


def test_flash_backward_matches_autograd_of_the_reference_path():
    """The ported backward against torch's own autograd through the
    reference path: the same gradient by another algorithm, in fp32."""
    q, k, v, w = _qkv(4, (2, 512, 2, 16), n=4)
    grads = []
    for fn in (lambda *a: tatt.flash_attention(*a, causal=True),
               lambda *a: tseq.full_attention(*a, True, use_flash="never")):
        tq, tk, tv = (t.requires_grad_() for t in _torch(q, k, v))
        (fn(tq, tk, tv) * torch.from_numpy(w)).sum().backward()
        grads.append((tq.grad, tk.grad, tv.grad))
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


def test_full_attention_auto_takes_the_reference_path_on_the_cpu():
    """As the JAX package does on its CPU backend: no kernel launch."""
    q, k, v = _torch(*_qkv(5, (1, 512, 2, 16)))
    before = FLASH_ATTENTION.launches
    got = tseq.full_attention(q, k, v, True)
    assert torch.equal(got, tseq.full_attention(q, k, v, True,
                                                use_flash="never"))
    assert FLASH_ATTENTION.launches == before


@pytest.mark.parametrize("dtype,d,route", [
    *((torch.bfloat16, d, "tc") for d in (8, 16, 24, 64, 128)),
    *((torch.float32, d, "f32") for d in (8, 64, 128, 512)),
    *((torch.bfloat16, d, "f32") for d in (136, 512, 2048))])
def test_route_is_fixed_by_dtype_and_head_dim(dtype, d, route):
    assert tatt._route(dtype, d) == route


def test_cpu_bf16_takes_the_plain_version_and_launches_neither_route():
    q, k, v = _torch(*_qkv(6, (1, 512, 2, 64)), dtype=torch.bfloat16)
    before = (FLASH_ATTENTION.launches, FLASH_ATTENTION_TC.launches)
    for causal in (False, True):
        assert torch.equal(tatt.flash_attention(q, k, v, causal=causal),
                           tatt.flash_attention_plain(q, k, v, causal))
    assert (FLASH_ATTENTION.launches, FLASH_ATTENTION_TC.launches) == before


# the tensor-core route's gate (module docstring): p rounded to bf16 moves
# each output by at most bf16's unit roundoff of max|v|; fp32 sums in
# another order by K3_F32_TOL; the bf16 output by one step; and on average
# by at most 2^-8 of the output's mean magnitude
TC_P_ROUNDING, K3_F32_TOL, TC_MEAN_CEILING = 2.0 ** -8, 2e-5, 2.0 ** -8


def _tc_gate(got, want, v):
    """(worst |dO| over its bound, mean |dO| over its ceiling): both <= 1
    pass."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs())
    step = torch.where(mag > 0, torch.exp2(torch.floor(torch.log2(mag)) - 7),
                       torch.zeros_like(mag))
    diff = (g - w).abs()
    bound = TC_P_ROUNDING * v.float().abs().max() + K3_F32_TOL + step
    return ((diff / bound).max().item(),
            (diff.mean() / (TC_MEAN_CEILING * w.abs().mean())).item())


def _tc_emulation(q, k, v, causal):
    """The tensor-core kernel's arithmetic in plain torch: 128 query rows a
    block, key tiles of 128 (64 at D > 64), bf16 products summed in fp32,
    -1e30 under the causal mask, a per-tile online max of the scores times
    one fp32 factor c = 1/sqrt(D) * log2(e), p = exp2(s c - m) with one
    rounding (the kernel's FMA), l summing the fp32 p and p rounded to bf16
    for p.v; acc / max(l, 1e-30) in bf16."""
    b, L, h, d = q.shape
    bk = 128 if d <= 64 else 64
    scale_log2 = torch.tensor(float(np.float32(1 / math.sqrt(d)))
                              * math.log2(math.e), dtype=torch.float32)
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    out = torch.empty((b, h, L, d), dtype=torch.bfloat16)
    for q0 in range(0, L, 128):
        rows = q0 + torch.arange(128)[:, None]
        m = torch.full((b, h, 128, 1), -1e30)
        l = torch.zeros((b, h, 128, 1))
        acc = torch.zeros((b, h, 128, d))
        for k0 in range(0, q0 + 128 if causal else L, bk):
            s = qf[:, :, q0:q0 + 128] @ kf[:, :, k0:k0 + bk].transpose(-1, -2)
            if causal:
                s = torch.where(k0 + torch.arange(bk)[None, :] > rows,
                                torch.full_like(s, -1e30), s)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True) * scale_log2)
            corr = torch.exp2(m - m_new)
            p = torch.exp2((s.double() * scale_log2.double()
                            - m_new.double()).float())
            l = l * corr + p.sum(dim=-1, keepdim=True)
            pv = p.to(torch.bfloat16).float() @ vf[:, :, k0:k0 + bk]
            acc = acc * corr + pv
            m = m_new
        out[:, :, q0:q0 + 128] = (acc / l.clamp(min=1e-30)).to(torch.bfloat16)
    return out.permute(0, 2, 1, 3)


@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_tensor_core_arithmetic_is_within_its_gate(d, causal):
    """The gate, rehearsed: the emulated tensor-core route against the plain
    version and against the interpreted JAX kernel, on bf16-valued inputs
    (the rehearsal reads at most 0.50 of the bound and 0.38 of the mean
    ceiling)."""
    q, k, v = _torch(*_qkv(7, (2, 512, 2, d)), dtype=torch.bfloat16)
    got = _tc_emulation(q, k, v, causal)
    plain = tatt.flash_attention_plain(q, k, v, causal)
    interpreted = torch.from_numpy(np.array(jatt.flash_attention(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)),
        causal=causal).astype(jnp.float32)))
    for want in (plain, interpreted):
        worst, mean = _tc_gate(got, want, v)
        assert worst <= 1.0 and mean <= 1.0, (worst, mean)


def test_make_attention_fn_gives_full_attention_and_refuses_meshes():
    assert tseq.make_attention_fn(None) is tseq.full_attention
    assert tseq.make_attention_fn(None, "full") is tseq.full_attention
    for impl in ("ring", "ulysses"):
        with pytest.raises(NotImplementedError, match="slice 6"):
            tseq.make_attention_fn(None, impl)
    with pytest.raises(NotImplementedError, match="slice 6"):
        tseq.make_attention_fn(object(), "auto")
    with pytest.raises(ValueError, match="unknown"):
        tseq.make_attention_fn(None, "sparse")
