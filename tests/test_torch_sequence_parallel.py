"""Ring and Ulysses attention in the port against the JAX package's.

The port's ranks are gloo processes of one module-scoped pool
(``mmlspark_tpu_torch.testing.ranks.RankPool``, functions in
``tests/torch_mesh_ranks.py``, no JAX there); each holds its slice of
the sequence on a ``seq`` axis of 4 (or data 2 x seq 2) and the outputs
are gathered back whole. The JAX side runs ``shard_map`` here on the
first 4 of conftest's 8 virtual CPU devices. Inputs are fp32 from
numpy with a seed, shapes as ``tests/test_sequence.py``'s.

Tolerance: 2e-5 (absolute and relative) against the JAX function on the
same mesh shape and against full attention, for outputs and for the
ring's gradients: the online softmax adds the blocks' contributions in
ring order where full attention sums a row at once.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mmlspark_tpu.parallel.mesh import MeshSpec as JMeshSpec
from mmlspark_tpu.parallel.mesh import make_mesh as jmake_mesh
from mmlspark_tpu.parallel.sequence import (
    full_attention as jfull_attention, ring_attention as jring_attention,
    ulysses_attention as julysses_attention,
)
from mmlspark_tpu_torch.testing.ranks import RankPool

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
B, L, H, D = 2, 16, 4, 8
TOL = 2e-5
SEQ4 = {"data": 1, "seq": 4}


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, paths=[TESTS, REPO]) as p:
        yield p


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(0)
    return tuple(rng.normal(0, 1, (B, L, H, D)).astype(np.float32)
                 for _ in range(3))


def _jax_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return jmake_mesh(JMeshSpec(**axes), jax.devices()[:n])


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sequence_parallel_attention_matches_reference(pool, qkv, impl,
                                                       causal):
    """Each rank's slice through the port's ring / Ulysses equals the JAX
    function's on the same seq=4 mesh, and full attention."""
    ranks = pool.run("torch_mesh_ranks:seq_attention", SEQ4, impl, *qkv,
                     causal)
    q, k, v = (jnp.asarray(x) for x in qkv)
    mesh = _jax_mesh(SEQ4)
    fn = {"ring": jring_attention, "ulysses": julysses_attention}[impl]
    with mesh:
        want = jax.jit(lambda q, k, v: fn(q, k, v, mesh=mesh,
                                          causal=causal))(q, k, v)
    full = jfull_attention(q, k, v, causal=causal)
    for r in ranks:
        _close(r["out"], want)
        _close(r["out"], full)


def test_ring_gradients_match_reference(pool, qkv):
    """The ring's backward (the reverse shift carrying the K/V
    gradients home) gives full attention's gradients of sum(out**2), and
    the JAX ring's, at data 2 x seq 2."""
    axes = {"data": 2, "seq": 2}
    ranks = pool.run("torch_mesh_ranks:seq_attention", axes, "ring", *qkv,
                     True, True)
    q, k, v = (jnp.asarray(x) for x in qkv)
    mesh = _jax_mesh(axes)

    def loss(fn):
        return lambda q, k, v: (fn(q, k, v) ** 2).sum()
    g_full = jax.grad(loss(lambda q, k, v: jfull_attention(q, k, v, True)),
                      argnums=(0, 1, 2))(q, k, v)
    with mesh:
        g_ring = jax.jit(jax.grad(loss(lambda q, k, v: jring_attention(
            q, k, v, mesh=mesh, causal=True)), argnums=(0, 1, 2)))(q, k, v)
    for r in ranks:
        for got, a, b in zip(r["grads"], g_full, g_ring):
            _close(got, a)
            _close(got, b)


def test_ulysses_refuses_indivisible_heads_and_auto_picks_ring(pool):
    """3 heads over |seq|=4 are refused with the reference's message; with
    a seq axis, "auto" is the ring."""
    ranks = pool.run("torch_mesh_ranks:ulysses_refusal", SEQ4, 3)
    for r in ranks:
        assert "divisible by |seq|=4" in r["refused"]
        assert r["auto_is_ring"]
    with pytest.raises(ValueError, match="divisible"):
        julysses_attention(jnp.zeros((1, 16, 3, 4)), jnp.zeros((1, 16, 3, 4)),
                           jnp.zeros((1, 16, 3, 4)), mesh=_jax_mesh(SEQ4))
