"""Capture-all output nodes against the JAX package.

The port's capture-all names (``models/zoo/__init__.py::capture_names``)
equal the JAX package's ``apply_with_intermediates(capture_all=True)``
keys, and ``TorchModel(outputNodeName=n)`` scores what
``JaxModel(outputNodeName=n)`` scores (a conv, a norm, a block output and
suffix matches per architecture) on the same parameters and inputs, fp32:
atol 1e-4 (the bound of ``test_torch_featurizer.py``). An unknown node
raises ``SchemaError`` in both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.frame import Frame as JFrame
from mmlspark_tpu.core.schema import SchemaError as JSchemaError
from mmlspark_tpu.models.jax_model import JaxModel
from mmlspark_tpu.models.zoo import build_model as jbuild
from mmlspark_tpu.models.zoo.resnet import (
    apply_with_intermediates as japply,
)
from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.core.schema import SchemaError
from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.models.zoo import (
    apply_with_intermediates, build_model, capture_names, init_state,
)
from mmlspark_tpu_torch.models.zoo.resnet import (
    apply_with_intermediates as resnet_apply,
)
from mmlspark_tpu_torch.utils import config as tconfig

TOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu_device():
    tconfig.set("runtime.device", "cpu")
    yield
    tconfig.unset("runtime.device")


# name, architecture kwargs, the net's input (B, ...), input dtype,
# the stage params that feed it
CASES = {
    "resnet20_cifar": (dict(num_classes=10, dtype="float32"),
                       (2, 16, 16, 3), "f",
                       dict(devicePreprocess={"srcShape": [16, 16, 3]})),
    "vit_tiny": (dict(num_classes=10, dtype="float32"), (2, 32, 32, 3), "f",
                 {}),
    "transformer_lm_tiny": (dict(vocab=64, max_len=16), (2, 16), "i", {}),
}

NODES = {
    "resnet20_cifar": ["stem_conv/out", "stage1_block0/conv2/out",
                       "stage0_block1/norm1/out", "stage1_block0/proj_norm/out",
                       "stage2_block2/out", "conv2/out", "out", "head",
                       "pool"],
    "vit_tiny": ["patch_embedding/out", "block1/norm2/out", "block2/out",
                 "block0/attn/query/out", "block3/mlp/out", "attn/out",
                 "final_norm/out"],
    "transformer_lm_tiny": ["token_embedding/out", "block0/norm1/out",
                            "block1/out", "block0/mlp_up/out", "head",
                            "final_norm/out"],
}


def _input(shape, kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "i":
        return rng.integers(0, 64, shape).astype(np.int32)
    return rng.normal(size=shape).astype(np.float32)


@pytest.fixture(scope="module")
def jmodels():
    """Each architecture's JaxModel-initialized flax params (numpy)."""
    out = {}
    for name, (kw, shape, kind, _) in CASES.items():
        jm = JaxModel()
        jm.set_model(name, seed=0, **kw)
        out[name] = jax.tree_util.tree_map(np.asarray, jm._state["params"])
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_capture_all_names_equal_the_jax_keys(name, jmodels):
    kw, shape, kind, _ = CASES[name]
    x = _input(shape, kind)
    jspec = jbuild(name, **kw)
    _, jinters = japply(jspec["module"], jmodels[name], jnp.asarray(x),
                        capture_all=True)
    module = build_model(name, **kw)["module"]
    module.load_state_dict({k: torch.from_numpy(v) for k, v in
                            init_state(module, 0).items()})
    with torch.no_grad():
        _, inters = apply_with_intermediates(module, torch.from_numpy(x),
                                             capture_all=True)
    assert set(inters) == set(jinters) == set(capture_names(module))
    for k, v in jinters.items():
        assert tuple(inters[k].shape) == tuple(v.shape), k
        assert str(inters[k].dtype).replace("torch.", "") == str(v.dtype), k
    # without capture_all only the sown layers and the head
    _, sown = apply_with_intermediates(module, torch.from_numpy(x))
    _, jsown = japply(jspec["module"], jmodels[name], jnp.asarray(x))
    assert set(sown) == set(jsown)


def _score_both(name, node, jparams):
    kw, shape, kind, stage = CASES[name]
    x = _input(shape, kind, seed=3)
    flat = x.reshape(x.shape[0], -1) if stage else x
    jm = JaxModel(inputCol="x", outputCol="o", miniBatchSize=2,
                  outputNodeName=node, **stage)
    jm.set_model(name, params=jparams, **kw)
    tm = TorchModel(inputCol="x", outputCol="o", miniBatchSize=2,
                    outputNodeName=node, **stage)
    tm.set_model(name, params=jparams, **kw)
    return ((jm, JFrame.from_dict({"x": flat})),
            (tm, Frame.from_dict({"x": flat})))


@pytest.mark.parametrize("name,node", [(n, node) for n in sorted(NODES)
                                       for node in NODES[n]])
def test_torch_model_node_matches_jax_model(name, node, jmodels):
    (jm, jframe), (tm, frame) = _score_both(name, node, jmodels[name])
    want = np.asarray(jm.transform(jframe).column("o"))
    got = np.asarray(tm.transform(frame).column("o"))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_unknown_node_raises_schema_error_in_both(name, jmodels):
    (jm, jframe), (tm, frame) = _score_both(name, "no_such_node",
                                            jmodels[name])
    with pytest.raises(JSchemaError, match="not found"):
        jm.transform(jframe)
    with pytest.raises(SchemaError, match="output node 'no_such_node' not "
                                          "found; have"):
        tm.transform(frame)


def test_capture_hooks_only_the_selected_module():
    """One hook, on the one submodule ``select`` picks, and none left
    behind after the pass."""
    module = build_model("resnet20_cifar", dtype="float32")["module"]
    module.load_state_dict({k: torch.from_numpy(v) for k, v in
                            init_state(module, 0).items()})
    from mmlspark_tpu_torch.models.zoo import node_forward
    installed = []
    real = torch.nn.Module.register_forward_hook

    def spy(self, hook, *a, **k):
        installed.append(self)
        return real(self, hook, *a, **k)
    torch.nn.Module.register_forward_hook = spy
    try:
        y = node_forward(module, "stage1_block2/out")(
            torch.from_numpy(_input((1, 16, 16, 3), "f")))
    finally:
        torch.nn.Module.register_forward_hook = real
    assert installed == [module.stage1_block2]
    assert y.shape == (1, 8, 8, 32)     # NHWC, as flax
    assert not any(m._forward_hooks for m in module.modules())
    # the ResNet wrapper keeps the reference's module-level entry point
    _, inters = resnet_apply(module, torch.zeros(1, 16, 16, 3),
                             capture_all=True)
    assert "stage3_block0/out" not in inters and "stem_conv/out" in inters
