"""Meshed training in the port against the JAX package's, on the CPU.

The port's ranks are gloo processes of one module-scoped pool per world
size (``mmlspark_tpu_torch.testing.ranks.RankPool``; their functions are
in ``tests/torch_mesh_ranks.py``, which imports no JAX). The JAX side
runs here on the first 2 or 4 of conftest's 8 virtual CPU devices. Both
start from one flax init (``from_jax_params``) and see the same global
batches, made with numpy from a seed.

Tolerances: the per-step losses are held at rtol 1e-5 against the JAX
trainer on the same mesh shape and against the port's one-device
trainer. The meshes reorder sums (row-split products summed over
``tensor``, gradients over the data ranks, the ring's blocks), and
adam's fp32 bias correction carries last-bit gradient differences into
its steps (ROADMAP §C); over these runs the differences stay below 1e-6.
Whole parameters after training are held at atol 1e-5 (lamb, adafactor:
2e-5, their trust ratio and factored moments are sums over a parameter
split across ranks), except the key projections' biases: softmax does not
change when a constant is added to every key's score, so their exact
gradient is zero, and adam turns the rounding left in it into steps of
the learning rate's size whose sign any reordering of the sums flips.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from mmlspark_tpu.models.zoo import build_model as jbuild
from mmlspark_tpu.parallel.mesh import MeshSpec as JMeshSpec
from mmlspark_tpu.parallel.mesh import make_mesh as jmake_mesh
from mmlspark_tpu.parallel.sequence import (
    make_attention_fn as jmake_attention_fn,
)
from mmlspark_tpu.parallel.trainer import (
    DistributedTrainer as JaxDistributedTrainer,
)
from mmlspark_tpu_torch.models.convert import from_jax_params
from mmlspark_tpu_torch.models.zoo.resnet import ResNet
from mmlspark_tpu_torch.models.zoo.transformer import (
    TransformerLM, next_token_loss,
)
from mmlspark_tpu_torch.models.zoo import init_state
from mmlspark_tpu_torch.parallel import optim
from mmlspark_tpu_torch.parallel.checkpoint import TrainCheckpointer
from mmlspark_tpu_torch.parallel.trainer import (
    DeviceEpochCache, DistributedTrainer,
)
from mmlspark_tpu_torch.testing.ranks import RankPool
from mmlspark_tpu_torch.utils import config as tconfig

import torch_mesh_ranks as R

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
RTOL = 1e-5
STEPS = 5
# exact gradient zero: adam's steps on them follow rounding (see above)
ZERO_GRAD = ("attn_key.bias",)
B, L = 8, R.LM["max_len"]


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


def _jax_lm(mesh=None, impl="full", **arch):
    attn = jmake_attention_fn(mesh, impl) if impl != "full" else None
    return jbuild("transformer_lm_tiny", **{**R.LM, **arch},
                  attention_fn=attn)["module"]


@pytest.fixture(scope="module")
def lm_init():
    module = _jax_lm()
    params = module.init(jax.random.PRNGKey(0), jnp.zeros((1, L), jnp.int32))
    # host copies: the JAX trainer donates the arrays it is given
    params = jax.tree_util.tree_map(np.asarray, params)
    return params, from_jax_params(params)


def _batches(n=STEPS, seed=0, b=B):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, R.LM["vocab"], (b, L)).astype(np.int32)
            for _ in range(n)]


def _jax_losses(jparams, axes, impl, batches, opt=None):
    """The JAX trainer on a mesh of ``axes`` over the first devices,
    state placed from the one host init (as tests/test_mesh2d.py does)."""
    n = int(np.prod(list(axes.values())))
    mesh = jmake_mesh(JMeshSpec(**axes), jax.devices()[:n])
    module = _jax_lm(mesh, impl)
    opt = opt or optax.adam(1e-2)

    def loss_fn(params, batch, rng):
        logits = module.apply(params, batch["tokens"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], batch["tokens"][:, 1:]).mean()
    trainer = JaxDistributedTrainer(
        loss_fn, opt, mesh=mesh,
        seq_axis="seq" if axes.get("seq", 1) > 1 else None)
    _, shardings = trainer.abstract_state(lambda: jparams)
    state = jax.device_put({"params": jparams,
                            "opt_state": opt.init(jparams),
                            "step": jnp.zeros((), jnp.int32)}, shardings)
    losses = []
    for b in batches:
        state, m = trainer.train_step(state, trainer.put_batch(
            {"tokens": b}), jax.random.PRNGKey(0))
        losses.append(float(jax.device_get(m["loss"])))
    return losses


def _port_one_device(tparams, batches, opt=None, module=None):
    def init_fn():
        m = module() if module else TransformerLM(**R.LM,
                                                  dtype=torch.float32)
        m.load_state_dict({k: torch.from_numpy(v) for k, v in
                           tparams.items()})
        return m
    trainer = DistributedTrainer(
        lambda m, b, g: next_token_loss(m, b["tokens"]),
        opt or optim.adam(1e-2))
    state = trainer.init(init_fn)
    losses = []
    for b in batches:
        state, m = trainer.train_step(state, trainer.put_batch(
            {"tokens": b}), 0)
        losses.append(float(m["loss"]))
    return losses, {n: p.detach().numpy() for n, p in
                    state["module"].named_parameters()}


MESHES = [
    ({"data": 2}, "full"),
    ({"data": 1, "tensor": 2}, "full"),
    ({"data": 2, "tensor": 2}, "full"),
    ({"data": 1, "seq": 2}, "ring"),
    ({"data": 1, "seq": 2}, "ulysses"),
    ({"data": 1, "tensor": 2, "seq": 2}, "ring"),
    # fsdp: every kernel's other dim split too, gathered for its use
    ({"data": 1, "fsdp": 2}, "full"),
    ({"data": 1, "fsdp": 2, "tensor": 2}, "full"),
]


@pytest.mark.parametrize("axes,impl", MESHES,
                         ids=[f"{'x'.join(f'{k}{v}' for k, v in a.items())}"
                              f"-{i}" for a, i in MESHES])
def test_lm_trains_on_a_mesh_like_the_reference(pools, lm_init, axes, impl):
    """transformer_lm at depth 2, 5 adam steps on the mesh: the losses
    match the JAX trainer on the same mesh shape and the port's
    one-device trainer; every rank holds only its shards (the tensor
    split halves the q/k/v rows, the vocabulary rows and attn_out's
    columns) and ends with the one-device trainer's parameters."""
    jparams, tparams = lm_init
    batches = _batches()
    world = int(np.prod(list(axes.values())))
    ranks = pools(world).run("torch_mesh_ranks:lm_train", axes, tparams,
                             batches, "adam", 1e-2, impl)
    want_jax = _jax_losses(jparams, axes, impl, batches)
    want_one, params_one = _port_one_device(tparams, batches)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want_jax, rtol=RTOL)
        np.testing.assert_allclose(r["losses"], want_one, rtol=RTOL)
        assert r["losses"] == ranks[0]["losses"]
    for name, value in params_one.items():
        if not name.endswith(ZERO_GRAD):
            np.testing.assert_allclose(ranks[0]["params"][name], value,
                                       atol=1e-5, rtol=0, err_msg=name)
    t, f = axes.get("tensor", 1), axes.get("fsdp", 1)
    shapes = ranks[0]["local_shapes"]
    assert shapes["block0.attn_query.weight"] == (32 // t, 32 // f)
    assert shapes["block0.attn_out.weight"] == (32 // f, 32 // t)
    assert shapes["token_embedding.embedding"] == (64 // t, 32)
    assert shapes["block0.norm1.weight"] == (32,)


@pytest.mark.parametrize("opt", ["lamb", "adafactor"])
@pytest.mark.parametrize("axes", [{"data": 1, "tensor": 2},
                                  {"data": 2, "tensor": 2}],
                         ids=["tensor2", "data2xtensor2"])
def test_lamb_and_adafactor_on_split_state_match_one_device(pools, axes,
                                                            opt):
    """Lamb's trust-ratio norms and Adafactor's factored row/column
    moments (dim 128: every matrix is factored) reduce over a whole
    parameter; on split parameters they sum over the ranks, and the
    trained parameters equal the one-device run's."""
    arch = {"dim": 128, "heads": 4}
    module = lambda: TransformerLM(**{**R.LM, **arch},  # noqa: E731
                                   dtype=torch.float32)
    tparams = init_state(module(), 0)
    batches = _batches(n=3)
    world = int(np.prod(list(axes.values())))
    ranks = pools(world).run("torch_mesh_ranks:lm_train", axes, tparams,
                             batches, opt, 1e-2, "full", arch)
    one = {"lamb": optim.lamb, "adafactor": optim.adafactor}[opt](1e-2)
    losses, params = _port_one_device(tparams, batches, one, module)
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=RTOL)
    for name, value in params.items():
        if not name.endswith(ZERO_GRAD):
            np.testing.assert_allclose(ranks[0]["params"][name], value,
                                       atol=2e-5, rtol=0, err_msg=name)


def test_modules_that_do_not_split_gather_their_shards(pools):
    """vit_tiny at data 2 x tensor 2: its attention and head weights are
    split over ``tensor`` by the rules, but its blocks compute whole, so
    each use gathers them (the gradient sliced back, not summed over the
    tensor ranks, which saw the same rows); the trained parameters equal
    the one-device run's (sgd: an update linear in the gradient, so a
    near-zero gradient's rounding is not blown up to a step as adam's
    sign-like update would)."""
    from mmlspark_tpu_torch.models.zoo import build_model
    module = lambda: build_model("vit_tiny", num_classes=10,  # noqa: E731
                                 image_size=16, patch=4,
                                 dtype="float32")["module"]
    tparams = init_state(module(), 0)
    rng = np.random.default_rng(3)
    images = rng.normal(0, 1, (3, 8, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 10, (3, 8)).astype(np.int64)
    ranks = pools(4).run("torch_mesh_ranks:vit_train",
                         {"data": 2, "tensor": 2}, tparams, images, labels)
    trainer = DistributedTrainer(
        lambda m, b, g: F.cross_entropy(m(b["image"]).float(),
                                        b["label"]), optim.sgd(0.05))

    def init_fn():
        m = module()
        m.load_state_dict({k: torch.from_numpy(v) for k, v in
                           tparams.items()})
        return m
    state = trainer.init(init_fn)
    losses = []
    for x, y in zip(images, labels):
        state, m = trainer.train_step(state, trainer.put_batch(
            {"image": x, "label": y}), 0)
        losses.append(float(m["loss"]))
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses, rtol=RTOL)
    assert ranks[0]["local_shapes"]["block0.attn.query.weight"] == (96, 192)
    assert ranks[0]["local_shapes"]["head.weight"] == (5, 192)
    for name, p in state["module"].named_parameters():
        np.testing.assert_allclose(ranks[0]["params"][name],
                                   p.detach().numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)


def test_epoch_cache_uploads_each_ranks_share_and_sequence_slice(pools):
    """At data 2 x seq 2 each rank uploads its rows of every batch (the
    rows of its data coordinate) and, for the token array, its slice of
    the sequence; a shuffled epoch is the one-device cache's order, cut
    the same way."""
    rng = np.random.default_rng(1)
    data = {"tokens": rng.integers(0, 50, (32, 8)).astype(np.int64),
            "label": np.arange(32, dtype=np.int64)}
    for shuffle in (False, True):
        ranks = pools(4).run("torch_mesh_ranks:epoch_cache",
                             {"data": 2, "seq": 2}, data, 8, shuffle, True)
        one = DeviceEpochCache(data, 8, shuffle=shuffle, seed=3)
        for r in ranks:
            d, s = r["coord"]["data"], r["coord"]["seq"]
            assert r["local_batch"] == 4
            # 4 steps x 4 rows x 4 tokens, and 4 x 4 labels, int64
            assert r["nbytes"] == (4 * 4 * 4 + 4 * 4) * 8
            for e, epoch in enumerate(r["epochs"]):
                for got, want in zip(epoch, one.batches(e)):
                    rows = slice(4 * d, 4 * d + 4)
                    np.testing.assert_array_equal(
                        got["tokens"], want["tokens"][rows, 4 * s:4 * s + 4])
                    np.testing.assert_array_equal(got["label"],
                                                  want["label"][rows])


def test_resnet_data_parallel_ranks_stay_bit_equal(pools):
    """A ResNet at data 2: both ranks hold bit-equal parameters after
    each step (the same summed gradients, the same update), within 1e-5
    of the one-device trainer on the same global batches."""
    arch = dict(stage_sizes=(1, 1, 1), width=8, num_classes=10,
                dtype=torch.float32)
    tparams = init_state(ResNet(**arch), 0)
    rng = np.random.default_rng(2)
    images = rng.normal(0, 1, (32, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 32).astype(np.int64)
    ranks = pools(2).run("torch_mesh_ranks:resnet_train", {"data": 2},
                         tparams, images, labels, 4, arch)
    for name, value in ranks[0]["params"].items():
        assert np.array_equal(value, ranks[1]["params"][name]), name

    def init_fn():
        m = ResNet(**arch)
        m.load_state_dict({k: torch.from_numpy(v) for k, v in
                           tparams.items()})
        return m
    trainer = DistributedTrainer(
        lambda m, b, g: F.cross_entropy(m(b["image"]).float(),
                                        b["label"].long()),
        optim.sgd(0.05))
    state = trainer.init(init_fn)
    losses = []
    for i in range(4):
        sl = slice(i * 8, (i + 1) * 8)
        state, m = trainer.train_step(state, trainer.put_batch(
            {"image": images[sl], "label": labels[sl]}), 0)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=RTOL)
    for name, p in state["module"].named_parameters():
        np.testing.assert_allclose(ranks[0]["params"][name],
                                   p.detach().numpy(), atol=1e-5, rtol=0)


def test_deep_classifier_mesh_spec_fits_data_parallel(pools, monkeypatch):
    """DeepClassifier(meshSpec={"data": 2}) on two ranks, each given its
    block-cyclic shard of the frame (``process_shard(block_rows=8)``, 8
    the rank's share of the global batch of 16): each rank splits off its
    own held-out rows, feeds its rows of every batch, and the weighted
    loss is the global batch's (rank 1's shard is 2 rows short of its
    quota and pads them with zero weight). The fit and its validation
    history equal, within 1e-5, the one-device fit over the same rows:
    the ranks' training rows interleaved in blocks of 8 (the global
    epoch's block-cyclic layout), their held-out rows together."""
    from mmlspark_tpu_torch.core.frame import Frame
    from mmlspark_tpu_torch.train import deep as tdeep
    from mmlspark_tpu_torch.train.deep import DeepClassifier
    rng = np.random.default_rng(4)
    # 98 rows: rank 0 holds blocks 0, 2, .., 12 (50 rows: 40 to train,
    # its quota), rank 1 blocks 1, .., 11 (48 rows: 38 to train)
    x = rng.normal(0, 1, (98, 6)).astype(np.float32)
    y = (x[:, 0] * x[:, 1] > 0).astype(np.int64)
    kwargs = dict(architecture="mlp_tabular", architectureArgs={
        "hidden": [16]}, trainDtype="float32", epochs=3, batchSize=16,
        learningRate=1e-2, seed=0, validationSplit=0.2)
    ranks = pools(2).run("torch_mesh_ranks:deep_fit", {"data": 2}, x, y,
                         kwargs, 8)
    whole = Frame.from_dict({"features": x, "label": y})
    splits = [tdeep._train_val_split(
        whole.process_shard(r, 2, block_rows=8), 0.2, 0) for r in (0, 1)]
    train = [s[0].collect() for s in splits]
    assert [len(t["label"]) for t in train] == [40, 38]
    order = [(r, i) for i in range(0, 40, 8) for r in (0, 1)]
    train = Frame.from_dict({k: np.concatenate(
        [train[r][k][i:i + 8] for r, i in order]) for k in train[0]})
    val = Frame.from_dict({k: np.concatenate(
        [s[1].collect()[k] for s in splits]) for k in ("features", "label")})
    monkeypatch.setattr(tdeep, "_train_val_split",
                        lambda frame, frac, seed: (train, val))
    one = DeepClassifier(featuresCol="features", labelCol="label",
                         **kwargs).fit(whole)
    for r in ranks:
        np.testing.assert_allclose(r["final_loss"],
                                   float(one._state["final_loss"]),
                                   rtol=RTOL)
        for name, value in one._state["params"].items():
            np.testing.assert_allclose(r["params"][name], value, atol=1e-5,
                                       rtol=0)
        got = [h["val_loss"] for h in r["history"]]
        np.testing.assert_allclose(
            got, [h["val_loss"] for h in one.validation_history], rtol=RTOL)


def test_checkpoint_restores_across_mesh_shapes(pools, lm_init, tmp_path):
    """Saved at 4x1 (data 4), restored at 2x2 (data 2 x tensor 2), saved,
    restored at 1x4 (tensor 4): each restore brings back the saved values
    whole, in the new mesh's shards, and steps on; the file also restores
    on one device, and the whole run matches the one-device trainer."""
    _, tparams = lm_init
    batches = _batches(n=6)
    directory = str(tmp_path / "ck")
    runs = pools(4).run("torch_mesh_ranks:checkpoint_across", tparams,
                        [batches[0:2], batches[2:4], batches[4:6]],
                        directory, ["4x1", "2x2", "1x4"])
    r0 = runs[0]
    for before, after in zip(r0, r0[1:]):
        assert after["restored"].keys() == before["restored"].keys()
    assert r0[0]["local_shapes"]["block0.attn_query.weight"] == (32, 32)
    assert r0[1]["local_shapes"]["block0.attn_query.weight"] == (16, 32)
    assert r0[2]["local_shapes"]["block0.attn_query.weight"] == (8, 32)
    assert [r["step"] for r in r0] == [2, 4, 6]
    losses, params = _port_one_device(tparams, batches)
    got = r0[0]["losses"] + r0[1]["losses"] + r0[2]["losses"]
    np.testing.assert_allclose(got, losses, rtol=RTOL)
    # the one-device trainer restores the last mesh's file
    ckpt = TrainCheckpointer(directory)
    trainer = DistributedTrainer(
        lambda m, b, g: next_token_loss(m, b["tokens"]), optim.adam(1e-2))
    state = ckpt.restore(trainer, lambda: TransformerLM(
        **R.LM, dtype=torch.float32))
    ckpt.close()
    assert int(state["step"]) == 6
    for name, p in state["module"].named_parameters():
        if not name.endswith(ZERO_GRAD):
            np.testing.assert_allclose(p.detach().numpy(), params[name],
                                       atol=1e-5, rtol=0, err_msg=name)


def test_reshard_to_moves_a_run_onto_a_new_mesh(pools, lm_init, tmp_path):
    """ResilientTrainLoop at data 4 with reshard_to("2x2") requested at
    step 2: the loop drains to a checkpoint at the step boundary, goes on
    at data 2 x tensor 2 with the same batches, and ends where an
    un-resharded run ends."""
    _, tparams = lm_init
    batches = _batches(n=4)
    pool = pools(4)
    moved = pool.run("torch_mesh_ranks:reshard_run", tparams, batches,
                     str(tmp_path / "a"), "4x1", "2x2", 2)
    stay = pool.run("torch_mesh_ranks:reshard_run", tparams, batches,
                    str(tmp_path / "b"), "4x1", None, 0)
    assert moved[0]["mesh"]["tensor"] == 2 and moved[0]["mesh"]["data"] == 2
    assert moved[0]["local_shapes"]["block0.attn_query.weight"] == (16, 32)
    assert stay[0]["mesh"]["data"] == 4
    assert moved[0]["step"] == stay[0]["step"] == 4
    for name, value in stay[0]["params"].items():
        if not name.endswith(ZERO_GRAD):
            np.testing.assert_allclose(moved[0]["params"][name], value,
                                       atol=1e-5, rtol=0, err_msg=name)
