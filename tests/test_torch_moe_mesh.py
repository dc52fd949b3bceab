"""The MoE LM on a mesh in the port against the JAX package, on the CPU.

The port's ranks are gloo processes of one module-scoped pool per world
size (``mmlspark_tpu_torch.testing.ranks.RankPool``; their functions are
in ``tests/torch_parallel_ranks.py``, which imports no JAX). The JAX side
runs here on the first 2 or 4 of conftest's 8 virtual CPU devices, where
GSPMD computes the layer over the GLOBAL batch. Both start from one flax
init (``from_jax_params``) and see the same numpy tokens.

The routing is discrete: the capacity, the slot positions in (choice,
token) order and the first-choice share behind the aux loss are all
global quantities. ``transformer_lm_moe_tiny`` runs here with its
capacity factor lowered to 0.5, so every expert overflows and some
choices are dropped; a rank that counted only its own tokens would keep
other choices (and compute its aux loss from its own means).

Tolerances: the gate indices and slot positions EQUAL the one-device
port's; logits atol 1e-5, ``moe_aux`` and the loss rtol 1e-5, gradients
atol 2e-6 (largest 0.2: the meshes sum the same products in other
orders, JAX and torch their fp32 GEMMs); losses of adamw steps rtol 1e-5
against the JAX trainer on the same mesh shape.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from mmlspark_tpu.models.zoo import build_model as jbuild
from mmlspark_tpu.models.zoo.moe import moe_aux_loss as jmoe_aux_loss
from mmlspark_tpu.parallel.mesh import MeshSpec as JMeshSpec
from mmlspark_tpu.parallel.mesh import make_mesh as jmake_mesh
from mmlspark_tpu.parallel.sequence import (
    make_attention_fn as jmake_attention_fn,
)
from mmlspark_tpu.parallel.sharding import param_shardings as jshardings
from mmlspark_tpu.parallel.trainer import (
    DistributedTrainer as JaxDistributedTrainer,
)
from mmlspark_tpu_torch.models.convert import from_jax_params
from mmlspark_tpu_torch.models.zoo import build_model
from mmlspark_tpu_torch.models.zoo.moe import moe_aux_loss
from mmlspark_tpu_torch.models.zoo.transformer import next_token_loss
from mmlspark_tpu_torch.parallel.sharding import param_shardings
from mmlspark_tpu_torch.testing.ranks import RankPool
from mmlspark_tpu_torch.utils import config as tconfig

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
# the multi-process JAX test's MoE LM (vocab 64, L 32, 4 experts), with
# its capacity cut so that every expert overflows: C = 32 of 64 choices
ARCH = dict(vocab=64, max_len=32, num_experts=4, capacity_factor=0.5)
B, L = 4, ARCH["max_len"]


@pytest.fixture(autouse=True)
def on_cpu():
    tconfig.set("runtime.device", "cpu")
    yield
    tconfig.unset("runtime.device")


@pytest.fixture(scope="module")
def pools():
    made = {}

    def get(world):
        if world not in made:
            made[world] = RankPool(world, paths=[TESTS, REPO])
        return made[world]
    yield get
    for pool in made.values():
        pool.close()


def _jax_moe(mesh=None, impl="full", **arch):
    attn = jmake_attention_fn(mesh, impl) if impl != "full" else None
    return jbuild("transformer_lm_moe_tiny", **{**ARCH, **arch},
                  attention_fn=attn)["module"]


@pytest.fixture(scope="module")
def moe_init():
    module = _jax_moe()
    params = module.init(jax.random.PRNGKey(0), jnp.zeros((1, L), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params)
    return params, from_jax_params(params)


def _tokens(seed=0, b=B):
    return np.random.default_rng(seed).integers(
        0, ARCH["vocab"], (b, L)).astype(np.int32)


def _jax_loss(module):
    def loss_fn(params, batch, rng=None):
        logits, state = module.apply(params, batch["tokens"],
                                     mutable=["losses"])
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], batch["tokens"][:, 1:]).mean()
        return ce + 0.01 * jmoe_aux_loss(state), (logits, state)
    return loss_fn


def _jax_step(jparams, axes, impl, tokens):
    """logits, moe_aux, loss and gradients of the JAX MoE LM, jitted over
    a mesh of ``axes`` (parameters placed by the JAX rules, the batch over
    the data axes and, under ``seq``, the sequence over ``seq``)."""
    n = int(np.prod(list(axes.values())))
    mesh = jmake_mesh(JMeshSpec(**axes), jax.devices()[:n])
    module = _jax_moe(mesh, impl)
    data = tuple(a for a in ("data",) if axes.get(a, 1) > 1) or None
    seq = "seq" if axes.get("seq", 1) > 1 else None
    params = jax.device_put(jparams, jshardings(jparams, mesh))
    toks = jax.device_put(tokens, NamedSharding(mesh, P(data, seq)))
    with mesh:
        (loss, (logits, state)), grads = jax.jit(jax.value_and_grad(
            lambda p, t: _jax_loss(module)(p, {"tokens": t}),
            has_aux=True))(params, toks)
    return {"loss": float(loss), "logits": np.asarray(logits),
            "moe_aux": float(jmoe_aux_loss(state)),
            "grads": from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                            grads))}


def _port_routing(tparams, tokens):
    """The first MoE block's gate indices and slot positions on one
    device (the global order), and its capacity."""
    module = build_model("transformer_lm_moe_tiny", **ARCH)["module"]
    module.load_state_dict({k: torch.from_numpy(v)
                            for k, v in tparams.items()})
    module.block1.ffn.record_routing = True
    with torch.no_grad():
        module(torch.from_numpy(tokens).long())
    r = module.block1.ffn.routing
    return r["gate_idx"].numpy(), r["position"].numpy(), r["capacity"]


def _rows(axes, coord, b, l):
    """The (batch, sequence) block of the rank at ``coord``."""
    nb = axes.get("data", 1)
    ns = axes.get("seq", 1)
    lb, ls = b // nb, l // ns
    return (slice(coord.get("data", 0) * lb, (coord.get("data", 0) + 1) * lb),
            slice(coord.get("seq", 0) * ls, (coord.get("seq", 0) + 1) * ls))


def _coords(axes, world):
    order = [a for a in ("data", "fsdp", "pipe", "expert", "seq", "tensor")]
    sizes = [axes.get(a, 1) for a in order]
    return [dict(zip(order, np.unravel_index(r, sizes))) for r in range(world)]


SPLITS = [({"data": 2}, "full"), ({"data": 1, "seq": 2}, "ring"),
          ({"data": 1, "expert": 2}, "full"),
          ({"data": 2, "expert": 2}, "full"),
          ({"data": 1, "expert": 2, "seq": 2}, "ring"),
          ({"data": 1, "tensor": 2}, "full"),
          ({"data": 1, "expert": 2, "tensor": 2}, "full")]


@pytest.mark.parametrize("axes,impl", SPLITS,
                         ids=["x".join(f"{k}{v}" for k, v in a.items())
                              for a, _ in SPLITS])
def test_moe_routes_over_the_global_batch_like_the_reference(
        pools, moe_init, axes, impl):
    """At capacity 0.5 every expert overflows: the capacity and the slot
    positions come from the GLOBAL batch in the reference's (choice,
    token b*L + l) order, and the aux loss from global means, so the
    logits, ``moe_aux``, the loss and the gradients of CE + 0.01 x aux
    on a split batch (data 2, seq 2 ring) and a split expert bank match
    the JAX package's, and each rank's gate indices and positions equal
    the one-device port's rows of the same tokens."""
    jparams, tparams = moe_init
    tokens = _tokens()
    world = int(np.prod(list(axes.values())))
    ranks = pools(world).run("torch_parallel_ranks:moe_step", axes,
                             tparams, tokens, ARCH, impl)
    want = _jax_step(jparams, axes, impl, tokens)
    gate, pos, cap = _port_routing(tparams, tokens)
    assert (pos >= cap).any() and (pos < cap).any()     # some dropped
    gate = gate.reshape(B, L, -1)
    pos = pos.reshape(B, L, -1)
    for r, coord in zip(ranks, _coords(axes, world)):
        np.testing.assert_allclose(r["logits"], want["logits"], atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(r["moe_aux"], want["moe_aux"], rtol=1e-5)
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-5)
        for name, g in want["grads"].items():
            np.testing.assert_allclose(r["grads"][name], g, atol=2e-6,
                                       rtol=0, err_msg=name)
        rows = _rows(axes, coord, B, L)
        assert np.array_equal(r["gate_idx"].reshape(gate[rows].shape),
                              gate[rows])
        assert np.array_equal(r["position"].reshape(pos[rows].shape),
                              pos[rows])
        e, t = axes.get("expert", 1), axes.get("tensor", 1)
        assert r["up_shape"] == (ARCH["num_experts"] // e, 64, 256 // t)
        assert r["down_shape"] == (ARCH["num_experts"] // e, 256 // t, 64)


def test_expert_banks_are_placed_as_the_reference_places_them():
    """data 2 x expert 4 (the JAX test's mesh) and expert 2 x tensor 2:
    the expert banks' leading dim over ``expert`` (their hidden dim over
    ``tensor``), the router replicated, as the JAX rules place them."""
    jmodule = _jax_moe()
    abstract = jax.eval_shape(lambda: jmodule.init(
        jax.random.PRNGKey(0), jnp.zeros((1, L), jnp.int32)))
    with torch.device("meta"):
        tmodule = build_model("transformer_lm_moe_tiny", **ARCH)["module"]
    for axes in ({"data": 2, "expert": 4}, {"data": 2, "expert": 2,
                                            "tensor": 2}):
        mesh = jmake_mesh(JMeshSpec(**axes))
        jspec = jshardings(abstract, mesh)["params"]["block1"]["ffn"]
        got = param_shardings(tmodule, JMeshSpec(**axes).resolve(8))
        for leaf in ("experts_up", "experts_down"):
            want = tuple(jspec[leaf].spec)
            port = got[f"block1.ffn.{leaf}"].spec
            assert port == want + (None,) * (3 - len(want)), leaf
        assert got["block1.ffn.experts_up"].spec[0] == "expert"
        assert not got["block1.ffn.router.weight"].sharded
        assert not got["block1.ffn.router.bias"].sharded


def _jax_train(jparams, axes, impl, batches, arch=None):
    n = int(np.prod(list(axes.values())))
    mesh = jmake_mesh(JMeshSpec(**axes), jax.devices()[:n])
    module = _jax_moe(mesh, impl, **(arch or {}))
    opt = optax.adamw(1e-3)
    loss = _jax_loss(module)
    trainer = JaxDistributedTrainer(
        lambda p, b, r: loss(p, b)[0], opt, mesh=mesh,
        seq_axis="seq" if axes.get("seq", 1) > 1 else None)
    _, shardings = trainer.abstract_state(lambda: jparams)
    state = jax.device_put({"params": jparams, "opt_state": opt.init(jparams),
                            "step": jnp.zeros((), jnp.int32)}, shardings)
    losses = []
    for b in batches:
        state, m = trainer.train_step(state, trainer.put_batch(
            {"tokens": b}), jax.random.PRNGKey(1))
        losses.append(float(jax.device_get(m["loss"])))
    return losses


TRAIN = [({"data": 2, "expert": 2}, "full"),
         ({"data": 1, "expert": 2, "seq": 2}, "ring"),
         ({"data": 1, "expert": 2, "tensor": 2}, "full")]


@pytest.mark.parametrize("axes,impl", TRAIN,
                         ids=["data2xexpert2", "expert2xseq2-ring",
                              "expert2xtensor2"])
def test_moe_lm_trains_on_an_expert_mesh_like_the_reference(
        pools, moe_init, axes, impl):
    """The JAX tests' MoE training (test_moe.py: data 2 x expert; the
    multi-process moe mode: expert 2 x seq 2 with ring attention):
    three adamw(1e-3) steps of CE + 0.01 x aux on one batch, the losses
    equal to the JAX trainer's on the same mesh and falling; each rank
    holds half the experts."""
    jparams, tparams = moe_init
    batches = [_tokens(seed=1, b=8)] * 3
    world = int(np.prod(list(axes.values())))
    ranks = pools(world).run("torch_parallel_ranks:moe_train", axes,
                             tparams, batches, ARCH, impl)
    want = _jax_train(jparams, axes, impl, batches)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want, rtol=1e-5)
        assert r["losses"] == ranks[0]["losses"]
        assert r["up_shape"][0] == ARCH["num_experts"] // 2
        assert r["shard_bytes"] == r["projected"]
    assert ranks[0]["losses"][-1] < ranks[0]["losses"][0]


def test_moe_aux_loss_sums_the_module_terms():
    """``moe_aux_loss`` of a module after its forward is the sum over its
    MoE blocks, the value ``forward_with_intermediates`` reports."""
    module = build_model("transformer_lm_moe_tiny", **ARCH)["module"]
    from mmlspark_tpu_torch.models.zoo import init_state
    module.load_state_dict({k: torch.from_numpy(v) for k, v in
                            init_state(module, 0).items()})
    tokens = torch.from_numpy(_tokens()).long()
    _, inters = module.forward_with_intermediates(tokens)
    assert torch.equal(moe_aux_loss(module), moe_aux_loss(inters))
    assert float(next_token_loss(module, tokens)) > 0


def test_moe_checkpoint_restores_across_expert_meshes(pools, moe_init,
                                                     tmp_path):
    """Saved at data 2 x expert 2 (half the experts a rank), restored at
    expert 4 (a quarter), then at data 4 (all of them): every restore
    equals its save."""
    _, tparams = moe_init
    steps = [[{"tokens": _tokens(seed=s, b=8)}] for s in range(3)]
    ranks = pools(4).run("torch_parallel_ranks:checkpoint_shapes", "moe",
                         {"params": tparams, "arch": ARCH}, steps,
                         str(tmp_path / "ck"),
                         [{"data": 2, "expert": 2}, {"data": 1, "expert": 4},
                          {"data": 4}])
    for r in ranks:
        for prev, cur in zip(r, r[1:]):
            for name, value in prev["saved"].items():
                assert np.array_equal(cur["restored"][name], value), name
        assert [c["local_shapes"]["block1.ffn.experts_up"][0] for c in r] \
            == [2, 1, 4]
        assert r[1]["specs"]["block1.ffn.experts_down"][0] == "expert"


@pytest.mark.parametrize("opt", ["lamb", "adafactor"])
def test_lamb_and_adafactor_norms_over_expert_split_banks(pools, moe_init,
                                                          opt):
    """Lamb's trust ratio and Adafactor's factored moments reduce over a
    whole bank: split over ``expert`` they sum over the ranks, and the
    losses and trained parameters equal the one-device run's (the bank's
    (E, 64, 256) factors its last two dims), the key biases excepted."""
    _, tparams = moe_init
    batches = [_tokens(seed=s, b=8) for s in range(3)]
    got = pools(2).run("torch_parallel_ranks:moe_train",
                       {"data": 1, "expert": 2}, tparams, batches, ARCH,
                       "full", opt, 1e-2)
    one = _port_one_device(tparams, batches, opt)
    np.testing.assert_allclose(got[0]["losses"], one["losses"], rtol=1e-5)
    for name, value in one["params"].items():
        # the key projections' biases have an exact gradient of zero: their
        # steps follow rounding, whose sign any reordering flips (ROADMAP C)
        if not name.endswith("attn_key.bias"):
            np.testing.assert_allclose(got[0]["params"][name], value,
                                       atol=2e-5, rtol=0, err_msg=name)


def _port_one_device(tparams, batches, opt):
    from mmlspark_tpu_torch.parallel import optim
    from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer
    module = build_model("transformer_lm_moe_tiny", **ARCH)["module"]
    module.load_state_dict({k: torch.from_numpy(v)
                            for k, v in tparams.items()})
    trainer = DistributedTrainer(
        lambda m, b, g: next_token_loss(m, b["tokens"])
        + 0.01 * moe_aux_loss(m),
        {"lamb": optim.lamb, "adafactor": optim.adafactor}[opt](1e-2),
        device=torch.device("cpu"))
    state = trainer.init(lambda: module)
    losses = []
    for b in batches:
        state, m = trainer.train_step(state, trainer.put_batch(
            {"tokens": b}), 0)
        losses.append(float(m["loss"]))
    return {"losses": losses, "params": {
        n: p.detach().numpy() for n, p in
        state["module"].named_parameters()}}
