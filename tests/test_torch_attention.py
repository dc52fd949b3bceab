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
  loop in fp32, rtol 1e-5 (with an atol of 1e-6 for outputs near zero);
- gradients of the ported backward against ``jax.grad`` of the JAX
  kernel's custom VJP: the same two blockwise passes in fp32, 1e-5
  (measured: 8e-7 at gradients of magnitude up to 3) where
  ``tests/test_sequence.py`` holds the flash gradient to the reference
  path's at 3e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.ops import pallas_attention as jatt
from mmlspark_tpu.parallel import sequence as jseq
from mmlspark_tpu_torch.kernels import FLASH_ATTENTION
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


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_matches_the_interpreted_jax_kernel(causal):
    q, k, v = _qkv(2, (2, 512, 2, 64))
    want = np.asarray(jatt.flash_attention(*map(jnp.asarray, (q, k, v)),
                                           causal=causal))
    got = tatt.flash_attention_plain(*_torch(q, k, v), causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


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
