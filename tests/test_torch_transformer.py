"""Parity of the port's attention models (``models/zoo/{transformer,moe,
vit}.py``) with the JAX package's flax modules, and of ``TorchModel`` with
``JaxModel`` on columns of token ids.

The flax parameters go through ``from_jax_params`` into the port's
modules; tokens and images come from numpy seeds. Tolerances:

- fp32 (the ``*_tiny`` zoo entries' own dtype): the same operations in
  another summation order, atol 2e-5 on activations and logits of
  magnitude up to 4 (measured: at most 3.4e-6);
- bf16 (the full-size entries' dtype): each Dense rounds its input,
  weights and output to 8 significant bits and the two frameworks round
  elementwise steps (gelu, the softmax) at other places, so the bound is
  5% of the output's scale at the worst element and 1% on average, as
  ``tests/test_torch_resnet.py`` holds the bf16 ResNets;
- the LM through the flash kernels (the interpreted Pallas kernel and the
  port's plain version of K3) at L = 512: fp32, 2e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.frame import Frame as JFrame
from mmlspark_tpu.models.jax_model import JaxModel
from mmlspark_tpu.models.zoo import build_model as jbuild
from mmlspark_tpu.ops import pallas_attention as jatt
from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.models import residency
from mmlspark_tpu_torch.models.convert import from_jax_params
from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.models.zoo import build_model, init_state
from mmlspark_tpu_torch.ops import attention as tatt
from mmlspark_tpu_torch.utils import config as tconfig

VOCAB = 256
F32_TOL = 2e-5


@pytest.fixture(autouse=True)
def _cpu_device():
    tconfig.set("runtime.device", "cpu")
    residency.clear()
    yield
    tconfig.unset("runtime.device")
    residency.clear()


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, VOCAB, shape).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def _flax_params(name, length, **kw):
    """flax params (numpy) of one zoo entry, from PRNGKey(0)."""
    module = jbuild(name, **kw)["module"]
    x = (jnp.zeros((1, length), jnp.int32) if "lm" in name
         else jnp.zeros((1, length, length, 3)))
    params = jax.jit(module.init)(jax.random.PRNGKey(0), x)
    return jax.tree_util.tree_map(np.array, params)


def _port(name, params, **kw):
    module = build_model(name, **kw)["module"]
    module.load_state_dict({k: torch.from_numpy(v) for k, v in
                            from_jax_params(params).items()}, strict=True)
    return module.eval()


def _flax_lm(name, params, tokens, **kw):
    """(logits, hidden, moe aux) of the flax LM as numpy."""
    module = jbuild(name, **kw)["module"]
    logits, state = module.apply(params, jnp.asarray(tokens),
                                 mutable=["intermediates", "losses"])
    aux = sum(float(np.sum(leaf)) for leaf in
              jax.tree_util.tree_leaves(state.get("losses", {})))
    return (np.asarray(logits, np.float32),
            np.asarray(state["intermediates"]["hidden"][0], np.float32), aux)


def _port_lm(module, tokens):
    with torch.no_grad():
        logits, inters = module.forward_with_intermediates(
            torch.from_numpy(tokens))
    aux = inters.get("moe_aux")
    return (logits.float().numpy(), inters["hidden"].float().numpy(),
            None if aux is None else float(aux))


def _close_in_bf16(got, want):
    scale = np.abs(want).max()
    err = np.abs(got - want)
    assert err.max() <= 0.05 * scale, (err.max(), scale)
    assert err.mean() <= 0.01 * scale, (err.mean(), scale)


@pytest.mark.parametrize("name", ["transformer_lm_tiny",
                                  "transformer_lm_moe_tiny"])
def test_lm_logits_and_hidden_match_flax_in_float32(name):
    params = _flax_params(name, 128)
    tokens = _tokens(1, (2, 128))
    want_logits, want_hidden, want_aux = _flax_lm(name, params, tokens)
    logits, hidden, aux = _port_lm(_port(name, params), tokens)
    assert logits.shape == (2, 128, VOCAB) and hidden.shape == (2, 128, 64)
    np.testing.assert_allclose(hidden, want_hidden, atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(logits, want_logits, atol=F32_TOL, rtol=0)
    if name == "transformer_lm_moe_tiny":
        # the load-balancing loss of the one MoE block, as flax sows it
        assert aux == pytest.approx(want_aux, rel=1e-5)
    else:
        assert aux is None and want_aux == 0


def test_lm_matches_flax_in_bfloat16():
    """The full-size entries' dtype: bf16 Dense layers and residual, fp32
    norms and head."""
    kw = dict(dtype=jnp.bfloat16)
    params = _flax_params("transformer_lm_tiny", 128, **kw)
    tokens = _tokens(2, (2, 128))
    want_logits, want_hidden, _ = _flax_lm("transformer_lm_tiny", params,
                                           tokens, **kw)
    logits, hidden, _ = _port_lm(
        _port("transformer_lm_tiny", params, dtype=torch.bfloat16), tokens)
    assert logits.dtype == np.float32
    _close_in_bf16(hidden, want_hidden)
    _close_in_bf16(logits, want_logits)


def test_moe_lm_routes_the_whole_padded_batch_like_flax():
    """Capacity C = ceil(cf * S * k / E) over all B * L tokens: at a factor
    of 0.5 half the choices overflow, and the port drops the same ones."""
    kw = dict(capacity_factor=0.5)
    params = _flax_params("transformer_lm_moe_tiny", 128, **kw)
    tokens = _tokens(3, (3, 128))
    want_logits, want_hidden, want_aux = _flax_lm(
        "transformer_lm_moe_tiny", params, tokens, **kw)
    logits, hidden, aux = _port_lm(
        _port("transformer_lm_moe_tiny", params, **kw), tokens)
    np.testing.assert_allclose(hidden, want_hidden, atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(logits, want_logits, atol=F32_TOL, rtol=0)
    assert aux == pytest.approx(want_aux, rel=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_tiny_matches_flax(dtype):
    kw = dict(num_classes=5, image_size=16, patch=4)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    params = _flax_params("vit_tiny", 16, **kw)
    images = np.random.default_rng(4).normal(size=(2, 16, 16, 3)).astype(
        np.float32)
    jmod = jbuild("vit_tiny", dtype=jdt, **kw)["module"]
    want_head, state = jmod.apply(params, jnp.asarray(images),
                                  mutable=["intermediates"])
    want_pool = np.asarray(state["intermediates"]["pool"][0], np.float32)
    module = _port("vit_tiny", params, dtype=dtype, **kw)
    with torch.no_grad():
        head, inters = module.forward_with_intermediates(
            torch.from_numpy(images))
    assert head.dtype == torch.float32 and inters["pool"].shape == (2, 192)
    for got, want in ((inters["pool"].numpy(), want_pool),
                      (head.numpy(), np.asarray(want_head, np.float32))):
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)
        else:
            _close_in_bf16(got, want)


def test_lm_through_the_flash_kernels_matches_flax_with_pallas():
    """attention_fn = the flash kernel on both sides, at L = 512 (the
    shortest length ``supports()`` admits): flax with the Pallas kernel in
    interpret mode, the port with K3's plain version on the CPU."""
    kw = dict(vocab=VOCAB, dim=64, depth=2, heads=4, max_len=512)
    params = _flax_params("transformer_lm_tiny", 512, **kw)
    tokens = _tokens(5, (1, 512))
    assert tatt.supports((1, 512, 4, 16))
    want_logits, want_hidden, _ = _flax_lm(
        "transformer_lm_tiny", params, tokens,
        attention_fn=jatt.flash_attention, **kw)
    logits, hidden, _ = _port_lm(
        _port("transformer_lm_tiny", params,
              attention_fn=tatt.flash_attention, **kw), tokens)
    np.testing.assert_allclose(hidden, want_hidden, atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(logits, want_logits, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("node", ["hidden", ""])
def test_torch_model_matches_jax_model_on_token_ids(node):
    """10 rows of float64 ids (a Frame stores them so) at miniBatchSize 4:
    a ragged last batch, ids coerced to int32 on the host."""
    ids = _tokens(6, (10, 32)).astype(np.float64)
    jm = JaxModel(inputCol="ids", outputCol="o", miniBatchSize=4,
                  outputNodeName=node)
    jm.set_model("transformer_lm_tiny", vocab=VOCAB, max_len=32, seed=0)
    jout = jm.transform(JFrame.from_dict({"ids": ids}))
    tm = TorchModel(inputCol="ids", outputCol="o", miniBatchSize=4,
                    outputNodeName=node)
    tm.set_model("transformer_lm_tiny", params=jm._state["params"],
                 vocab=VOCAB, max_len=32)
    tout = tm.transform(Frame.from_dict({"ids": ids}))
    want = np.asarray(jout.column("o"))
    got = np.asarray(tout.column("o"))
    width = 64 if node == "hidden" else VOCAB
    assert got.shape == want.shape == (10, 32, width)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)
    # the JAX package's quirk for a 3-D output, kept: the column's dim is L
    assert tout.schema["o"].dim == jout.schema["o"].dim == 32


def test_torch_model_hidden_skips_the_head():
    """Only ``hidden`` asked for: the vocab-wide head never runs."""
    module = build_model("transformer_lm_tiny")["module"]
    module.load_state_dict({k: torch.from_numpy(v) for k, v in
                            init_state(module, 0).items()})
    calls = []
    module.head = lambda h: calls.append(h) or h
    tokens = torch.from_numpy(_tokens(7, (2, 16)))
    out, inters = module.forward_with_intermediates(tokens,
                                                    layers=("hidden",))
    assert out is None and set(inters) == {"hidden"} and not calls
    module.forward_with_intermediates(tokens)
    assert len(calls) == 1


def test_torch_model_mesh_scoring_still_raises():
    tm = TorchModel(inputCol="ids", outputCol="o", miniBatchSize=4,
                    meshSpec={"data": 2})
    tm.set_model("transformer_lm_tiny", seed=0)
    # outside a process group a mesh of two ranks has no ranks to score on
    with pytest.raises(RuntimeError, match="process group"):
        tm.transform(Frame.from_dict({"ids": _tokens(8, (4, 128))}))


@pytest.mark.parametrize("name,x", [
    ("transformer_lm", jnp.zeros((1, 2048), jnp.int32)),
    ("transformer_lm_moe", jnp.zeros((1, 2048), jnp.int32)),
    ("vit_b16", jnp.zeros((1, 224, 224, 3)))])
def test_full_width_parameter_names_and_shapes_match_flax(name, x):
    """The zoo's full-size attention models map one to one (shapes only,
    from ``jax.eval_shape``: nothing runs at that width on the CPU)."""
    shapes = jax.eval_shape(jbuild(name)["module"].init,
                            jax.random.PRNGKey(0), x)
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = from_jax_params(zeros)
    module = build_model(name)["module"]
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    assert {k: v.shape for k, v in sd.items()} == want


def test_init_state_draws_the_flax_initializers():
    lm = build_model("transformer_lm_moe_tiny", dim=64, num_experts=4)
    a = init_state(lm["module"], 0)
    emb = a["token_embedding.embedding"]                       # (256, 64)
    assert abs(emb.std() * np.sqrt(64) - 1.0) < 0.05           # N(0, 1/D)
    assert np.abs(emb).max() > 3.0 / np.sqrt(64)               # untruncated
    assert abs(a["pos_embedding"].std() - 0.02) < 0.002
    up = a["block1.ffn.experts_up"]                            # (4, 64, 256)
    assert abs(up.std() * np.sqrt(4 * 64) - 1.0) < 0.05        # fan_in E*D
    assert np.all(a["block0.norm1.weight"] == 1.0)
    assert np.all(a["block1.ffn.router.bias"] == 0.0)
    vit = init_state(build_model("vit_tiny")["module"], 0)
    assert np.all(vit["cls"] == 0.0)
    q = vit["block0.attn.query.weight"]                        # (192, 192)
    assert abs(q.std() * np.sqrt(192) - 1.0) < 0.05
