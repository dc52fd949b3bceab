"""Parity of the port's ResNets (``mmlspark_tpu_torch.models.zoo.resnet``)
with the JAX package's flax ResNets, from the same parameters.

The flax parameters go through ``from_jax_params`` into the port's modules;
inputs come from a numpy seed. Built with ``dtype=float32`` the two
frameworks run the same algorithm in fp32 and agree to 1e-4 (summation
order differs between XLA's and torch's CPU convolutions). The constructors'
default bfloat16 convs round at different places in the two frameworks, so
that case is held to a looser bound stated at the test.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.models.zoo import resnet as jres
from mmlspark_tpu_torch.models.convert import from_jax_params
from mmlspark_tpu_torch.models.zoo import (
    available_models, build_model, init_state, resolve_dtype,
)
from mmlspark_tpu_torch.models.zoo import resnet as tres

ARCHS = {
    "resnet20_cifar": dict(stage_sizes=(3, 3, 3), width=16, num_classes=10),
    "narrow_bottleneck_imagenet_stem": dict(
        stage_sizes=(1, 1), width=8, bottleneck=True, cifar_stem=False,
        num_classes=5),
}


@functools.lru_cache(maxsize=None)
def _init(name):
    """flax params (numpy) of one test architecture; params are float32
    whatever the compute dtype, so both dtypes share them."""
    jmod = jres.ResNet(**ARCHS[name])
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, 32, 32, 3)))
    return jax.tree_util.tree_map(np.array, params)


def _pair(dtype, name):
    """(flax params as numpy, flax module, port module with those params)."""
    kw = ARCHS[name]
    jmod = jres.ResNet(dtype=jnp.dtype(dtype), **kw)
    params = _init(name)
    tmod = tres.ResNet(dtype=dtype, **kw)
    tmod.load_state_dict({k: torch.from_numpy(v) for k, v in
                          from_jax_params(params).items()}, strict=True)
    return params, jmod, tmod.eval()


def _run_both(params, jmod, tmod, x):
    jl, ji = jax.jit(lambda p, x: jres.apply_with_intermediates(jmod, p, x))(
        params, jnp.asarray(x))
    with torch.no_grad():
        tl, ti = tres.apply_with_intermediates(tmod, torch.from_numpy(x))
    return (np.asarray(jl), np.asarray(ji["pool"]),
            tl.numpy(), ti["pool"].numpy())


def _images(seed, n=4):
    return np.random.default_rng(seed).normal(
        size=(n, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_float32_logits_and_pool_match_flax(name):
    params, jmod, tmod = _pair("float32", name)
    jl, jp, tl, tp = _run_both(params, jmod, tmod, _images(1))
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tp, jp, atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_bfloat16_default_dtype_matches_flax_loosely(name):
    """bf16 convs: each rounds its inputs to 8 significant bits, and the
    two frameworks accumulate in other orders, so a relative error of a
    few 2^-8 steps per layer is expected. Bound: 5% of the output's scale
    at the worst element; the mean error must stay under 1% of it."""
    params, jmod, tmod = _pair("bfloat16", name)
    jl, jp, tl, tp = _run_both(params, jmod, tmod, _images(2))
    for got, want in ((tl, jl), (tp, jp)):
        assert got.dtype == np.float32
        scale = np.abs(want).max()
        err = np.abs(got - want)
        assert err.max() <= 0.05 * scale, (err.max(), scale)
        assert err.mean() <= 0.01 * scale, (err.mean(), scale)


def test_same_padding_is_asymmetric_at_stride_two():
    """flax SAME at stride 2 on an even size pads (0, 1): on a 4x4 ramp
    with a ones kernel flax gives [[45,39],[66,50]]; torch's symmetric
    padding=1 would give [[10,24],[51,90]]."""
    assert tres._same_pads(4, 3, 2) == (0, 1)
    assert tres._same_pads(5, 3, 2) == (1, 1)
    assert tres._same_pads(32, 1, 2) == (0, 0)
    conv = tres.Conv(1, 1, 3, 2, dtype="float32")
    with torch.no_grad():
        conv.weight.fill_(1.0)
        x = torch.arange(16.0).reshape(1, 1, 4, 4)
        assert conv(x)[0, 0].tolist() == [[45.0, 39.0], [66.0, 50.0]]


def test_max_pool_same_pads_with_minus_inf():
    x = -torch.arange(1.0, 17.0).reshape(1, 1, 4, 4)  # all negative
    want = jax.lax.reduce_window(
        jnp.asarray(x.numpy().transpose(0, 2, 3, 1)), -jnp.inf, jax.lax.max,
        (1, 3, 3, 1), (1, 2, 2, 1), "SAME")
    got = tres._max_pool_same(x).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_from_jax_params_layout_rules():
    tree = {"params": {
        "conv": {"kernel": np.arange(24.0).reshape(2, 2, 3, 2)},   # HWIO
        "fc": {"kernel": np.arange(6.0).reshape(3, 2),
               "bias": np.zeros(2)},
        "norm": {"scale": np.ones(4), "bias": np.zeros(4)},
    }}
    sd = from_jax_params(tree)
    assert sd["conv.weight"].shape == (2, 3, 2, 2)                # OIHW
    np.testing.assert_array_equal(sd["conv.weight"],
                                  tree["params"]["conv"]["kernel"]
                                  .transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["fc.weight"],
                                  tree["params"]["fc"]["kernel"].T)
    assert set(sd) == {"conv.weight", "fc.weight", "fc.bias",
                       "norm.weight", "norm.bias"}
    with pytest.raises(ValueError, match="rank 3"):
        from_jax_params({"c1d": {"kernel": np.zeros((2, 3, 2))}})
    assert all(v.flags["C_CONTIGUOUS"] for v in sd.values())
    # the "params" collection key is optional
    assert set(from_jax_params(tree["params"])) == set(sd)


def test_zoo_registry_and_specs_match_the_jax_zoo():
    from mmlspark_tpu.models.zoo import build_model as jbuild
    assert available_models() == [
        "mlp_tabular", "resnet20_cifar", "resnet50", "transformer_lm",
        "transformer_lm_moe", "transformer_lm_moe_tiny",
        "transformer_lm_tiny", "vit_b16", "vit_tiny"]
    for name in available_models():
        t, j = build_model(name), jbuild(name)
        for key in ("input_shape", "feature_layer", "feature_dim",
                    "layer_names"):
            assert tuple(np.atleast_1d(t[key])) == tuple(np.atleast_1d(j[key]))
        for key in ("input_dtype", "seq_attention"):
            assert t.get(key) == j.get(key)
    with pytest.raises(KeyError):
        build_model("textcnn")        # slice 3 of the port


def test_resnet50_parameter_names_and_shapes_match_flax():
    """The full-width ResNet-50 maps one to one (shape check only, from
    ``jax.eval_shape``: nothing is run at that width on the CPU)."""
    jmod = jres.ResNet(stage_sizes=[3, 4, 6, 3], num_classes=1000, width=64,
                       bottleneck=True, cifar_stem=False)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 224, 224, 3)))
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = from_jax_params(zeros)
    module = build_model("resnet50")["module"]
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    assert {k: v.shape for k, v in sd.items()} == want
    assert sum(int(np.prod(s)) for s in want.values()) == 25_557_032


def test_init_state_is_lecun_normal_and_seeded():
    module = build_model("resnet20_cifar", dtype="float32")["module"]
    a, b = init_state(module, 3), init_state(module, 3)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["stem_conv.weight"],
                              init_state(module, 4)["stem_conv.weight"])
    w = a["stage2_block0.conv2.weight"]           # (64, 64, 3, 3)
    assert abs(w.std() * np.sqrt(64 * 9) - 1.0) < 0.05
    assert np.abs(w).max() <= 2.0 / np.sqrt(64 * 9) / 0.8796 + 1e-6
    assert np.all(a["stage0_block0.norm1.weight"] == 1.0)
    assert np.all(a["head.bias"] == 0.0)


def test_resolve_dtype_accepts_names_and_dtypes():
    assert resolve_dtype("bfloat16") is torch.bfloat16
    assert resolve_dtype(torch.float32) is torch.float32
    with pytest.raises(ValueError):
        resolve_dtype("float128x")
