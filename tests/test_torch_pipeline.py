"""Pipeline parallelism in the port against the JAX package, on the CPU.

The port's ranks are gloo processes of one module-scoped pool per world
size (functions in ``tests/torch_parallel_ranks.py``, no JAX there); the
JAX side runs here on the first 4 of conftest's 8 virtual CPU devices.
Both take the same stacked stage parameters and inputs, made with numpy
from a seed (JAX's ``init_stage_params`` draws, carried as arrays).

Tolerances: outputs and gradients atol 1e-5, as the JAX tests hold their
pipelines against the sequential stack (the ranks sum the same products;
JAX and torch run other fp32 GEMMs); trained losses rtol 1e-5 against
the port's one-device trainer, whole parameters after training atol
1e-5. Against the JAX trainer on the same mesh shape the adam losses are
held at rtol 5e-5: optax computes adam's bias correction in fp32, and on
this MLP its third step reads 1.3e-5 from torch's on one device already
(under sgd the two agree to 3e-7).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmlspark_tpu.parallel.mesh import MeshSpec as JMeshSpec
from mmlspark_tpu.parallel.mesh import make_mesh as jmake_mesh
from mmlspark_tpu.parallel.mesh import parse_mesh_shape as jparse_shape
from mmlspark_tpu.parallel.pipeline_parallel import (
    init_stage_params as jinit_stage_params,
    pipeline_apply as jpipeline_apply,
)
from mmlspark_tpu.parallel.sharding import (
    param_shardings as jshardings,
    pipeline_stacked_rules as jstacked_rules,
)
from mmlspark_tpu.parallel.trainer import (
    DistributedTrainer as JaxDistributedTrainer,
)
from mmlspark_tpu_torch.parallel.pipeline_parallel import (
    StageStack, init_stage_params, pipeline_apply, pipeline_spec,
    stack_stage_params,
)
from mmlspark_tpu_torch.parallel.sharding import (
    param_shardings, pipeline_stacked_rules,
)
from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer
from mmlspark_tpu_torch.testing.ranks import RankPool
from mmlspark_tpu_torch.utils import config as tconfig

import torch_parallel_ranks as P

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
DIM = 16
S = 4      # pipeline stages
ATOL = 1e-5
DATA_PIPE = {"data": 2, "pipe": 2}


@pytest.fixture(autouse=True)
def on_cpu():
    tconfig.set("runtime.device", "cpu")
    yield
    tconfig.unset("runtime.device")


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, paths=[TESTS, REPO]) as p:
        yield p


def _jstage(params, x):
    h = jnp.tanh(x @ params["w1"] + params["b1"])
    return x + h @ params["w2"]


def _jinit(key, i):
    k1, k2 = jax.random.split(key)
    return {"w1": jax.random.normal(k1, (DIM, DIM * 2), jnp.float32) * 0.1,
            "b1": jnp.zeros((DIM * 2,), jnp.float32),
            "w2": jax.random.normal(k2, (DIM * 2, DIM), jnp.float32) * 0.1}


def _stacked(n=S, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jinit_stage_params(_jinit, n, jax.random.PRNGKey(seed)))


def _x(seed, rows=8):
    return np.random.default_rng(seed).normal(0, 1, (rows, DIM)).astype(
        np.float32)


def _sequential(stacked, x):
    t = {k: torch.from_numpy(v) for k, v in stacked.items()}
    out = torch.from_numpy(x)
    for i in range(next(iter(t.values())).shape[0]):
        out = P._residual_mlp({k: v[i] for k, v in t.items()}, out)
    return out.numpy()


def _jax_pipe(stacked, x, axes, n_micro):
    mesh = jmake_mesh(JMeshSpec(**axes), jax.devices()[:4])
    with mesh:
        return np.asarray(jax.jit(lambda p, x: jpipeline_apply(
            _jstage, p, x, mesh, n_microbatches=n_micro))(stacked, x))


def test_pipeline_matches_sequential(pool):
    """data 2 x pipe 2, 4 stages (two a rank), 4 microbatches: the output
    equals the sequential stack's and the JAX pipeline's."""
    stacked, x = _stacked(), _x(0)
    got = pool.run("torch_parallel_ranks:pipe_apply", DATA_PIPE,
                   "residual_mlp", stacked, x, 4)
    want = _jax_pipe(stacked, x, DATA_PIPE, 4)
    for r in got:
        np.testing.assert_allclose(r["out"], _sequential(stacked, x),
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(r["out"], want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_pipeline_microbatch_counts(pool, n_micro):
    stacked, x = _stacked(), _x(1)
    got = pool.run("torch_parallel_ranks:pipe_apply", DATA_PIPE,
                   "residual_mlp", stacked, x, n_micro)
    for r in got:
        np.testing.assert_allclose(r["out"], _sequential(stacked, x),
                                   atol=ATOL, rtol=0)


def test_pipeline_gradients_match_sequential(pool):
    """The gradients of mean(out**2) over the global batch through the
    schedule's backward (the reverse hops, the last rank's cotangent
    once) equal the sequential stack's and the JAX pipeline's."""
    stacked, x = _stacked(), _x(2)
    got = pool.run("torch_parallel_ranks:pipe_apply", DATA_PIPE,
                   "residual_mlp", stacked, x, 4, True)
    t = {k: torch.from_numpy(v).requires_grad_() for k, v in stacked.items()}
    out = torch.from_numpy(x)
    for i in range(S):
        out = P._residual_mlp({k: v[i] for k, v in t.items()}, out)
    (out ** 2).mean().backward()
    mesh = jmake_mesh(JMeshSpec(**DATA_PIPE), jax.devices()[:4])
    with mesh:
        jg = jax.jit(jax.grad(lambda p: (jpipeline_apply(
            _jstage, p, x, mesh, n_microbatches=4) ** 2).mean()))(stacked)
    for r in got:
        np.testing.assert_allclose(r["loss"], float((out ** 2).mean()),
                                   rtol=1e-6)
        for k, v in t.items():
            np.testing.assert_allclose(r["grads"][k], v.grad.numpy(),
                                       atol=ATOL, rtol=0, err_msg=k)
            np.testing.assert_allclose(r["grads"][k], np.asarray(jg[k]),
                                       atol=ATOL, rtol=0, err_msg=k)


def test_pipeline_trivial_axis_falls_back(pool):
    """data 4 (|pipe| = 1): the stages run in sequence on each rank's
    rows, as the reference's scan."""
    stacked, x = _stacked(), _x(3)
    got = pool.run("torch_parallel_ranks:pipe_apply", {"data": 4},
                   "residual_mlp", stacked, x, 2)
    for r in got:
        np.testing.assert_allclose(r["out"], _sequential(stacked, x),
                                   atol=1e-6, rtol=0)
    # and without a mesh at all
    out = pipeline_apply(P._residual_mlp, P._tree(stacked),
                         torch.from_numpy(x), None, 2)
    np.testing.assert_allclose(out.numpy(), _sequential(stacked, x),
                               atol=1e-6, rtol=0)


def test_pipeline_rejects_indivisible_batch(pool):
    """7 global rows do not split over data 2; 8 rows are 4 a data rank,
    fewer than 8 microbatches. The JAX pipeline refuses both."""
    stacked = _stacked()
    for rows, n_micro in ((7, 4), (8, 8)):
        got = pool.run("torch_parallel_ranks:pipe_refusal", DATA_PIPE,
                       stacked, rows, DIM, n_micro)
        assert all(g is not None for g in got), (rows, n_micro)
        mesh = jmake_mesh(JMeshSpec(**DATA_PIPE), jax.devices()[:4])
        with pytest.raises(ValueError):
            jpipeline_apply(_jstage, stacked,
                            jnp.zeros((rows, DIM), jnp.float32), mesh,
                            n_microbatches=n_micro)
    assert "n_microbatches=8" in got[0]


def test_pipeline_rejects_stage_count_not_multiple_of_ranks(pool):
    """6 stages on a pipe of 4: refused with the reference's message."""
    stacked6 = _stacked(6, seed=9)
    got = pool.run("torch_parallel_ranks:pipe_refusal", {"data": 1,
                                                         "pipe": 4},
                   stacked6, 8, DIM, 4)
    mesh = jmake_mesh(JMeshSpec(data=1, pipe=4), jax.devices()[:4])
    with pytest.raises(ValueError) as e:
        jpipeline_apply(_jstage, stacked6, jnp.zeros((8, DIM), jnp.float32),
                        mesh, n_microbatches=4)
    assert all(g == str(e.value) for g in got)


def test_pipeline_virtual_stages_two_per_rank(pool):
    """8 stacked stages on a 4-rank pipe: each rank chains two."""
    stacked8, x = _stacked(8, seed=7), _x(8)
    got = pool.run("torch_parallel_ranks:pipe_apply", {"data": 1, "pipe": 4},
                   "residual_mlp", stacked8, x, 4)
    want = _jax_pipe(stacked8, x, {"data": 1, "pipe": 4}, 4)
    for r in got:
        np.testing.assert_allclose(r["out"], _sequential(stacked8, x),
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(r["out"], want, atol=ATOL, rtol=0)


def test_stack_and_init_stage_params():
    a = [{"w": torch.ones(2)}, {"w": torch.zeros(2)}]
    s = stack_stage_params(a)
    assert s["w"].shape == (2, 2) and torch.equal(s["w"][0], torch.ones(2))
    nested = stack_stage_params([{"mlp": {"w": torch.full((3,), float(i))}}
                                 for i in range(3)])
    assert nested["mlp"]["w"].shape == (3, 3)

    def init(gen, i):
        return {"w": torch.randn(4, generator=gen)}
    one = init_stage_params(init, 3, torch.Generator().manual_seed(5))
    two = init_stage_params(init, 3, torch.Generator().manual_seed(5))
    assert torch.equal(one["w"], two["w"])        # seeded: repeatable
    assert not torch.equal(one["w"][0], one["w"][1])   # distinct stages
    assert pipeline_spec() == ("pipe",)


# -- the multi-process JAX test's pipe mode -----------------------------------

def _tanh_init(key, i):
    return {"w": jax.random.normal(key, (DIM, DIM), jnp.float32) * 0.1}


def _jtanh(params, x):
    return x + jnp.tanh(x @ params["w"])


def test_pipe_mode_of_the_multiprocess_test(pool):
    """test_multiprocess_modelparallel.py's pipe mode: data 2 x pipe 2, 4
    stages of x + tanh(x @ w), 2 microbatches; the value and the sum of
    |gradient| of mean(out**2) equal the JAX package's."""
    stacked = jax.tree_util.tree_map(np.asarray, jinit_stage_params(
        _tanh_init, 4, jax.random.PRNGKey(0)))
    x = np.random.default_rng(0).normal(0, 1, (8, DIM)).astype(np.float32)
    mesh = jmake_mesh(JMeshSpec(**DATA_PIPE), jax.devices()[:4])
    with mesh:
        val, grads = jax.jit(jax.value_and_grad(lambda p: (jpipeline_apply(
            _jtanh, p, x, mesh, n_microbatches=2) ** 2).mean()))(stacked)
    gnorm = float(sum(np.abs(np.asarray(g)).sum()
                      for g in jax.tree_util.tree_leaves(grads)))
    got = pool.run("torch_parallel_ranks:pipe_apply", DATA_PIPE, "tanh",
                   stacked, x, 2, True)
    for r in got:
        np.testing.assert_allclose(r["loss"], float(val), rtol=1e-5)
        np.testing.assert_allclose(
            sum(np.abs(g).sum() for g in r["grads"].values()), gnorm,
            rtol=1e-5)


# -- training: the (data, tensor, pipe) trainer --------------------------------

def _pipe_host(d=16, hidden=32, n_stages=4):
    """test_mesh2d's one host init: stacked stage kernels in the JAX
    layouts and the head; the port takes them transposed."""
    rng = np.random.default_rng(0)
    up = rng.normal(0, d ** -0.5, (n_stages, d, hidden)).astype(np.float32)
    down = rng.normal(0, hidden ** -0.5, (n_stages, hidden, d)).astype(
        np.float32)
    head = rng.normal(0, d ** -0.5, (d, 1)).astype(np.float32)
    jparams = {"stages": {"mlp_up_kernel": up, "mlp_down_kernel": down},
               "head_kernel": head}
    host = {"up": np.ascontiguousarray(up.transpose(0, 2, 1)),
            "down": np.ascontiguousarray(down.transpose(0, 2, 1)),
            "head": np.ascontiguousarray(head.T)}
    return jparams, host


def _pipe_batches(steps=3, d=16):
    out = []
    for i in range(steps):
        r = np.random.default_rng(40 + i)
        out.append({"x": r.normal(size=(8, d)).astype(np.float32),
                    "y": r.normal(size=(8,)).astype(np.float32)})
    return out


def _jax_pipe_train(jparams, mesh, batches, opt=None):
    def stage(p, x):
        return x + jnp.tanh(x @ p["mlp_up_kernel"]) @ p["mlp_down_kernel"]

    def loss_fn(params, batch, rng):
        h = jpipeline_apply(stage, params["stages"], batch["x"], mesh,
                            n_microbatches=2)
        pred = (h @ params["head_kernel"])[:, 0]
        return jnp.mean((pred - batch["y"]) ** 2)
    opt = opt or optax.adam(1e-2)
    trainer = JaxDistributedTrainer(loss_fn, opt, mesh=mesh,
                                    rules=jstacked_rules())
    params = jax.tree_util.tree_map(jnp.asarray, jparams)
    _, shardings = trainer.abstract_state(lambda: params)
    state = jax.device_put({"params": params, "opt_state": opt.init(params),
                            "step": jnp.zeros((), jnp.int32)}, shardings)
    losses = []
    for b in batches:
        state, m = trainer.train_step(state, trainer.put_batch(b),
                                      jax.random.PRNGKey(0))
        losses.append(float(jax.device_get(m["loss"])))
    return losses, shardings


def _port_one_device(host, batches, opt="adam", lr=1e-2):
    trainer = DistributedTrainer(lambda m, b, g: P.pipe_loss(m, b),
                                 P._optimizer(opt, lr),
                                 device=torch.device("cpu"))
    state = trainer.init(lambda: P.PipeMLP(host))
    losses = []
    for b in batches:
        state, m = trainer.train_step(state, trainer.put_batch(b), 0)
        losses.append(float(m["loss"]))
    return losses, {n: p.detach().numpy() for n, p in
                    state["module"].named_parameters()}


@pytest.mark.parametrize("opt", ["adam", "sgd"])
@pytest.mark.parametrize("shape", ["1x2x2", "2x1x2"])
def test_train_3d_pipeline_topology_matches_the_reference(pool, shape, opt):
    """test_mesh2d's 3-D composition at 4 ranks: ``parse_mesh_shape``
    gives (data, tensor, pipe), ``pipeline_stacked_rules`` places the
    stage leaves pipe first with their hidden dim over ``tensor`` and the
    head outside the pipeline without ``pipe``; the losses equal the JAX
    trainer's on the same shape (rtol 1e-5 under sgd, 5e-5 under adam:
    see the module docstring) and the port's one-device run's, the
    trained parameters the one-device run's; a rank holds and projects
    fewer bytes than the whole."""
    jparams, host = _pipe_host()
    batches = _pipe_batches()
    got = pool.run("torch_parallel_ranks:pipe_train", shape, host, batches,
                   opt)
    jmesh = jmake_mesh(jparse_shape(shape), jax.devices()[:4])
    want, jsh = _jax_pipe_train(jparams, jmesh, batches,
                                {"adam": optax.adam, "sgd": optax.sgd}[opt](
                                    1e-2))
    one, params = _port_one_device(host, batches, opt)
    jup = tuple(jsh["params"]["stages"]["mlp_up_kernel"].spec)
    jdown = tuple(jsh["params"]["stages"]["mlp_down_kernel"].spec)
    for r in got:
        np.testing.assert_allclose(r["losses"], want,
                                   rtol={"adam": 5e-5, "sgd": 1e-5}[opt])
        np.testing.assert_allclose(r["losses"], one, rtol=1e-5)
        for name, value in params.items():
            np.testing.assert_allclose(r["params"][name], value, atol=ATOL,
                                       rtol=0, err_msg=name)
        up = r["specs"]["stages.mlp_up.weight"]
        down = r["specs"]["stages.mlp_down.weight"]
        # torch layout: the kernel's last two dims swapped
        assert up[0] == "pipe" and (up[0], up[2], up[1]) == (
            jup + (None,) * 3)[:3]
        assert (down[0], down[2], down[1]) == (jdown + (None,) * 3)[:3]
        assert "pipe" not in r["specs"]["head.weight"]
        t = jmesh.shape["tensor"]
        assert r["local_shapes"]["stages.mlp_up.weight"] == (2, 32 // t, 16)
        assert r["shard_bytes"] == r["projected"] < r["param_bytes"]
    assert got[0]["losses"][-1] < got[0]["losses"][0]


def test_pipeline_stacked_rules_place_like_the_reference():
    """A stacked transformer-block tree under ``stages`` and a head
    outside it at data 2 x tensor 2 x pipe 2 (with fsdp 2 at 16
    devices): every stacked leaf carries ``pipe`` on its stage dim and
    the JAX rules' axes on the dims its layout maps them to."""
    n, d, h = 4, 16, 64
    jtree = {"params": {
        "stages": {"attn_query": {"kernel": np.zeros((n, d, d)),
                                  "bias": np.zeros((n, d))},
                   "attn_out": {"kernel": np.zeros((n, d, d))},
                   "mlp_up": {"kernel": np.zeros((n, d, h))},
                   "mlp_down": {"kernel": np.zeros((n, h, d))},
                   "norm1": {"scale": np.zeros((n, d))}},
        "head": {"kernel": np.zeros((d, 8))}}}
    ttree = {"stages.attn_query.weight": np.zeros((n, d, d)),
             "stages.attn_query.bias": np.zeros((n, d)),
             "stages.attn_out.weight": np.zeros((n, d, d)),
             "stages.mlp_up.weight": np.zeros((n, h, d)),
             "stages.mlp_down.weight": np.zeros((n, d, h)),
             "stages.norm1.weight": np.zeros((n, d)),
             "head.weight": np.zeros((8, d))}
    for axes in (dict(data=2, tensor=2, pipe=2), dict(data=1, fsdp=2,
                                                     tensor=2, pipe=2)):
        n_dev = int(np.prod(list(axes.values())))
        mesh = jmake_mesh(JMeshSpec(**axes), jax.devices()[:n_dev])
        jsh = jshardings(jtree, mesh, jstacked_rules())["params"]
        got = param_shardings(ttree, JMeshSpec(**axes).resolve(n_dev),
                              pipeline_stacked_rules())

        def spec(node, rank):
            return (tuple(node.spec) + (None,) * rank)[:rank]
        for mod in ("attn_query", "attn_out", "mlp_up", "mlp_down"):
            j = spec(jsh["stages"][mod]["kernel"], 3)
            assert got[f"stages.{mod}.weight"].spec == (j[0], j[2], j[1]), \
                (mod, axes)
        assert got["stages.attn_query.bias"].spec == spec(
            jsh["stages"]["attn_query"]["bias"], 2)
        assert got["stages.norm1.weight"].spec == spec(
            jsh["stages"]["norm1"]["scale"], 2) == ("pipe", None)
        j = spec(jsh["head"]["kernel"], 2)
        assert got["head.weight"].spec == (j[1], j[0])


def test_stage_stack_runs_in_sequence_without_a_mesh():
    """A ``StageStack`` not bound to a mesh chains its stages in order."""
    _, host = _pipe_host()
    module = P.PipeMLP(host)
    x = torch.from_numpy(_x(5))
    out = module.stages(P._pipe_stage, x, 2)
    want = x
    for i in range(4):
        want = P._pipe_stage({"mlp_up": {"weight": module.stages.mlp_up
                                         .weight[i]},
                              "mlp_down": {"weight": module.stages.mlp_down
                                           .weight[i]}}, want)
    assert torch.equal(out, want)
    assert isinstance(module.stages, StageStack)
    names = dict(module.named_parameters())
    assert set(names) == {"stages.mlp_up.weight", "stages.mlp_down.weight",
                          "head.weight"}


@pytest.mark.parametrize("opt", ["lamb", "adafactor"])
def test_lamb_and_adafactor_norms_over_pipe_split_leaves(pool, opt):
    """Lamb's trust ratio and Adafactor's RMS are whole-leaf reductions:
    over stage leaves split over ``pipe`` (and ``tensor``) they sum over
    the ranks holding the shards, and the trained parameters equal the
    one-device run's (hidden 256: Adafactor factors the stage kernels)."""
    _, host = _pipe_host(hidden=256)
    batches = _pipe_batches()
    got = pool.run("torch_parallel_ranks:pipe_train", "1x2x2", host,
                   batches, opt, 1e-2)
    one, params = _port_one_device(host, batches, opt, 1e-2)
    np.testing.assert_allclose(got[0]["losses"], one, rtol=1e-5)
    for name, value in params.items():
        np.testing.assert_allclose(got[0]["params"][name], value, atol=2e-5,
                                   rtol=0, err_msg=name)


# -- checkpoints and reshards across mesh shapes -----------------------------

def test_pipe_checkpoint_restores_across_mesh_shapes(pool, tmp_path):
    """Saved at data 4, restored at data 2 x pipe 2 (each rank half the
    stages), then at tensor 2 x pipe 2 (half the stages, half their
    hidden dim), then back: every restore equals its save."""
    _, host = _pipe_host()
    batches = _pipe_batches(8)
    steps = [batches[i:i + 2] for i in range(0, 8, 2)]
    ranks = pool.run("torch_parallel_ranks:checkpoint_shapes", "pipe",
                     {"host": host}, steps, str(tmp_path / "ck"),
                     ["4", "2x1x2", "1x2x2", "4"])
    for r in ranks:
        for prev, cur in zip(r, r[1:]):
            for name, value in prev["saved"].items():
                assert np.array_equal(cur["restored"][name], value), name
        assert [c["local_shapes"]["stages.mlp_up.weight"] for c in r] == \
            [(4, 32, 16), (2, 32, 16), (2, 16, 16), (4, 32, 16)]
        assert [c["step"] for c in r] == [2, 4, 6, 8]


def test_reshard_to_moves_a_pipelined_run_and_back(pool, tmp_path):
    """``ResilientTrainLoop.reshard_to`` from data 4 to data 2 x pipe 2
    at step 3 and back at step 5 (the reference bench's 1-D -> 3-D
    reshard of its train half): the run ends where the one-device run
    ends, on the mesh it was last sent to."""
    _, host = _pipe_host()
    batches = _pipe_batches(6)
    ranks = pool.run("torch_parallel_ranks:pipe_reshard", host, batches,
                     str(tmp_path / "ck"), "4", [(3, "2x1x2"), (5, "4")])
    _, params = _port_one_device(host, batches)
    for r in ranks:
        assert r["step"] == 6 and r["mesh"]["data"] == 4
        assert r["up_shape"] == (4, 32, 16)
        for name, value in params.items():
            np.testing.assert_allclose(r["params"][name], value, atol=ATOL,
                                       rtol=0, err_msg=name)
