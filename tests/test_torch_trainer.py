"""The port's training path against the JAX package's, on the CPU.

K1's plain version against the JAX ``make_preprocess_fn`` (Pallas in
interpret mode), and the port's ``DistributedTrainer`` /
``DeviceEpochCache`` against the JAX ones from one converted init and one
unshuffled epoch of the same batches. The JAX side runs on a one-device
mesh so its sums run in one order. Tolerances are stated at each test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from mmlspark_tpu.models.zoo import resnet as jres
from mmlspark_tpu.ops.pallas_preprocess import (
    make_preprocess_fn as jax_make_preprocess_fn,
)
from mmlspark_tpu.parallel.mesh import data_parallel_mesh
from mmlspark_tpu.parallel.trainer import (
    DeviceEpochCache as JaxDeviceEpochCache,
    DistributedTrainer as JaxDistributedTrainer,
)
from mmlspark_tpu_torch.kernels import FUSED_NORMALIZE
from mmlspark_tpu_torch.models.convert import from_jax_params
from mmlspark_tpu_torch.models.zoo.resnet import ResNet
from mmlspark_tpu_torch.observability import metrics as tmetrics
from mmlspark_tpu_torch.observability import syncs as tsyncs
from mmlspark_tpu_torch.ops import preprocess as tpre
from mmlspark_tpu_torch.parallel.optim import sgd
from mmlspark_tpu_torch.parallel.trainer import (
    DeviceEpochCache, DistributedTrainer,
)
from mmlspark_tpu_torch.reliability import watchdog
from mmlspark_tpu_torch.reliability.faults import (
    FaultPlan, FaultSpec, InjectedFault,
)
from mmlspark_tpu_torch.utils import config as tconfig

CIFAR_MEAN, CIFAR_STD = (125.3, 123.0, 113.9), (63.0, 62.1, 66.7)
# image side of the training parity test. At 8x8 the last stage's
# GroupNorm normalizes each channel over 2x2 values, and the JAX reference
# alone then turns a 1e-7 relative change of its init into a 1e-2 change
# of the loss within 20 steps at this learning rate: no two
# implementations can agree there. At 16x16 (4x4 per channel) the same
# change stays at 1e-7.
HW = 16


@pytest.fixture(autouse=True)
def on_cpu():
    tconfig.set("runtime.device", "cpu")
    yield
    tconfig.unset("runtime.device")


def _u8(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


# -- K1's plain version against the JAX kernel ------------------------------

def test_k1_plain_matches_jax_float32_at_the_reference_test_shape():
    """The case of the JAX package's own K1 test (5 images of 6x6x3,
    mean (1, 2, 3), std 2): both compute (x - mean) * (1/std) in fp32, so
    they agree to rounding; held at atol 1e-6 as that test holds K1."""
    u8 = _u8(0, (5, 6 * 6 * 3))
    jpre = jax_make_preprocess_fn((6, 6, 3), mean=(1.0, 2.0, 3.0),
                                  std=(2.0, 2.0, 2.0), out_dtype=jnp.float32)
    want = np.asarray(jpre(jnp.asarray(u8)))
    tp = tpre.make_preprocess_fn((6, 6, 3), mean=(1.0, 2.0, 3.0),
                                 std=(2.0, 2.0, 2.0), out_dtype=torch.float32)
    got = tp(torch.from_numpy(u8))
    assert tuple(got.shape) == want.shape == (5, 6, 6, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_k1_plain_matches_jax_bfloat16_exactly():
    """(4, 8*8*3) with the CIFAR constants, bf16 out: the same two fp32
    roundings, then round-to-nearest-even to bf16 on both sides, so the
    outputs are bit-equal (tolerance 0)."""
    u8 = _u8(1, (4, 8 * 8 * 3))
    jpre = jax_make_preprocess_fn((8, 8, 3), mean=CIFAR_MEAN, std=CIFAR_STD)
    want = np.asarray(jpre(jnp.asarray(u8)).astype(jnp.float32))
    got = tpre.make_preprocess_fn((8, 8, 3), mean=CIFAR_MEAN,
                                  std=CIFAR_STD)(torch.from_numpy(u8))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_k1_wrapper_takes_the_plain_version_on_the_cpu_without_counting():
    u8 = torch.from_numpy(_u8(2, (3, 4, 4, 3)))
    mean = torch.tensor(CIFAR_MEAN, dtype=torch.float32)
    istd = torch.from_numpy(tpre._inv_std(CIFAR_STD))
    before = FUSED_NORMALIZE.launches
    got = tpre.fused_normalize(u8, mean, istd, torch.float32)
    assert FUSED_NORMALIZE.launches == before
    want = (u8.float() - mean) * istd
    assert torch.equal(got, want)


# -- the trainer against the JAX trainer ------------------------------------

def _narrow_resnet_pair():
    """A narrow ResNet (stages [1, 1, 1], width 8, fp32) in both packages
    with one init: the flax params, converted into the port's module."""
    kw = dict(stage_sizes=(1, 1, 1), width=8, num_classes=10,
              dtype=jnp.float32)
    jmod = jres.ResNet(**kw)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, HW, HW, 3)))
    params = jax.tree_util.tree_map(np.array, params)
    tmod = ResNet([1, 1, 1], num_classes=10, width=8, dtype="float32")
    tmod.load_state_dict({k: torch.from_numpy(v) for k, v in
                          from_jax_params(params).items()}, strict=True)
    return jmod, params, tmod


def test_trainer_tracks_the_jax_trainer_step_for_step():
    """20 steps of sgd(0.1, momentum 0.9) on 16x16x3 uint8 images, batch 16,
    K1 inside the loss, from one init and one unshuffled epoch cache in
    each package. fp32 throughout; the two frameworks' CPU convolutions
    sum in other orders, so each step's loss is held at rtol 1e-4."""
    images = _u8(3, (160, HW * HW * 3))
    labels = np.random.default_rng(4).integers(0, 10, 160).astype(np.int32)
    jmod, params, tmod = _narrow_resnet_pair()

    jpre = jax_make_preprocess_fn((HW, HW, 3), mean=CIFAR_MEAN,
                                  std=CIFAR_STD, out_dtype=jnp.float32)

    def jloss(p, batch, rng):
        logits = jmod.apply(p, jpre(batch["image"])).astype(jnp.float32)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, batch["label"]).mean()

    mesh = data_parallel_mesh(jax.devices()[:1])
    jtr = JaxDistributedTrainer(jloss, optax.sgd(0.1, momentum=0.9),
                                mesh=mesh)
    jstate = jtr.init(lambda: jax.tree_util.tree_map(jnp.asarray, params))
    jcache = JaxDeviceEpochCache({"image": images, "label": labels}, 16,
                                 mesh=mesh)
    want = []
    for epoch in range(2):
        for b in jcache.batches(epoch):
            jstate, m = jtr.train_step(jstate, b, jax.random.PRNGKey(1))
            want.append(float(m["loss"]))

    tp = tpre.make_preprocess_fn((HW, HW, 3), mean=CIFAR_MEAN,
                                 std=CIFAR_STD, out_dtype=torch.float32)

    def tloss(module, batch, gen):
        logits = module(tp(batch["image"])).float()
        return F.cross_entropy(logits, batch["label"].long())

    ttr = DistributedTrainer(tloss, sgd(0.1, momentum=0.9))
    tstate = ttr.init(lambda: tmod)
    tcache = DeviceEpochCache({"image": images, "label": labels}, 16)
    got = []
    for epoch in range(2):
        for b in tcache.batches(epoch):
            tstate, m = ttr.train_step(tstate, b, 1)
            got.append(float(m["loss"]))
    assert len(got) == len(want) == 20
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert int(tstate["step"]) == 20
    assert ttr.flops_per_step > 0


def _linear_problem():
    X = np.arange(16, dtype=np.float32).reshape(8, 2) / 10
    return X, X.sum(axis=1)


class _Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(2))


def _linear_loss(module, batch, gen):
    return ((batch["x"] @ module.w - batch["y"]) ** 2).mean()


@pytest.mark.parametrize("accum", [1, 2])
def test_trainer_accum_matches_plain(accum):
    """The port of the JAX package's accumulation test: accum_steps=2 makes
    (numerically close to) the same first update as one full-batch step,
    rtol 1e-5; each also matches the JAX trainer's update at rtol 1e-6."""
    X, y = _linear_problem()

    def port_step(a):
        tr = DistributedTrainer(_linear_loss, sgd(0.1), accum_steps=a)
        state = tr.init(_Linear)
        state, _ = tr.train_step(state, tr.put_batch({"x": X, "y": y}))
        return state["module"].w.detach().numpy()

    def jloss(p, batch, _rng):
        return ((batch["x"] @ p["w"] - batch["y"]) ** 2).mean()

    jtr = JaxDistributedTrainer(jloss, optax.sgd(0.1),
                                mesh=data_parallel_mesh(jax.devices()[:1]),
                                accum_steps=accum)
    js = jtr.init(lambda: {"w": jnp.zeros(2, jnp.float32)})
    js, _ = jtr.train_step(js, jtr.put_batch({"x": X, "y": y}),
                           jax.random.PRNGKey(0))
    np.testing.assert_allclose(port_step(accum), port_step(1), rtol=1e-5)
    np.testing.assert_allclose(port_step(accum),
                               np.asarray(js["params"]["w"]), rtol=1e-6)


def test_remat_gives_the_same_update():
    X, y = _linear_problem()

    def one(remat):
        tr = DistributedTrainer(_linear_loss, sgd(0.1), remat=remat)
        state = tr.init(_Linear)
        state, _ = tr.train_step(state, tr.put_batch({"x": X, "y": y}))
        return state["module"].w.detach().numpy()
    np.testing.assert_array_equal(one(True), one(False))


# -- the epoch cache ---------------------------------------------------------

def test_epoch_cache_batches_match_the_host_slices():
    x = np.arange(40 * 4, dtype=np.float32).reshape(40, 4)
    y = np.arange(40, dtype=np.int32)
    cache = DeviceEpochCache({"x": x, "y": y}, batch_size=8)
    assert cache.steps_per_epoch == 5
    assert cache.nbytes == x.nbytes + y.nbytes
    got = list(cache.batches(0))
    assert len(got) == 5
    for i, b in enumerate(got):
        np.testing.assert_array_equal(b["x"].numpy(), x[i * 8:(i + 1) * 8])
        np.testing.assert_array_equal(b["y"].numpy(), y[i * 8:(i + 1) * 8])


def test_epoch_cache_drops_the_tail_with_a_warning():
    x = np.arange(43, dtype=np.float32)[:, None]
    with pytest.warns(UserWarning, match="drops 3 of 43 rows"):
        cache = DeviceEpochCache({"x": x}, batch_size=8)
    rows = np.concatenate([b["x"].numpy()[:, 0] for b in cache.batches(0)])
    np.testing.assert_array_equal(rows, x[:40, 0])
    with pytest.raises(ValueError, match="smaller than the batch"):
        DeviceEpochCache({"x": x[:4]}, batch_size=8)


def test_epoch_cache_shuffle_is_deterministic_and_complete():
    x = np.arange(64, dtype=np.float32).reshape(64, 1)

    def epoch_rows(cache, epoch):
        return np.concatenate([b["x"].numpy()[:, 0]
                               for b in cache.batches(epoch)])
    c1 = DeviceEpochCache({"x": x}, 8, shuffle=True, seed=3)
    c2 = DeviceEpochCache({"x": x}, 8, shuffle=True, seed=3)
    e0 = epoch_rows(c1, 0)
    np.testing.assert_array_equal(e0, epoch_rows(c2, 0))
    e1 = epoch_rows(c1, 1)
    assert not np.array_equal(e0, e1)
    np.testing.assert_array_equal(np.sort(e0), x[:, 0])
    np.testing.assert_array_equal(np.sort(e1), x[:, 0])
    np.testing.assert_array_equal(epoch_rows(c1, 0), e0)  # replayable
    other = DeviceEpochCache({"x": x}, 8, shuffle=True, seed=4)
    assert not np.array_equal(epoch_rows(other, 0), e0)


def test_epoch_cache_fits_charges_the_peak():
    data = {"x": np.broadcast_to(np.float32(0), (1000, 250))}  # 1 MB
    assert DeviceEpochCache.fits(data, budget_mb=2.0)
    assert not DeviceEpochCache.fits(data, budget_mb=2.0, shuffle=True)


# -- syncs, telemetry, refusals ---------------------------------------------

@pytest.fixture
def metrics_on():
    tmetrics.get_registry().reset()
    tconfig.set("observability.metrics", True)
    yield tmetrics.get_registry()
    tconfig.unset("observability.metrics")
    tmetrics.get_registry().reset()


def test_fit_steps_without_syncs_and_flushes_once_per_interval(metrics_on):
    """40 streamed steps with a 16-step ring: the steps themselves make no
    host sync (the gauge reads 0.0), and the ring is read once per 16
    steps, 40 // 16 = 2 times."""
    X, y = _linear_problem()
    tr = DistributedTrainer(_linear_loss, sgd(0.01))
    state = tr.init(_Linear)
    state, losses = tr.fit(state, [{"x": X, "y": y}] * 40)
    reg = metrics_on.to_dict()
    assert reg["train.sync_points_per_step"]["value"] == 0.0
    assert reg["observability.sync_points.trainer.flush"]["value"] == 2
    assert reg["trainer.step_time_seconds"]["count"] == 40
    assert reg["trainer.examples_per_sec"]["value"] > 0
    assert len(losses) == 40 and losses[-1] < losses[0]
    assert tr.last_flush["step"] == 32
    np.testing.assert_allclose(tr.last_flush["loss"], losses[16:32])
    assert "trainer.mfu" not in reg        # no MFU off the card
    # the fit's and the prefetcher's heartbeats deregister when they end
    assert not [hb for hb in watchdog.registered()
                if hb.name in ("trainer.fit", "data.prefetch")]


def test_train_step_has_a_fault_site():
    X, y = _linear_problem()
    tr = DistributedTrainer(_linear_loss, sgd(0.1))
    state = tr.init(_Linear)
    batch = tr.put_batch({"x": X, "y": y})
    with FaultPlan(FaultSpec("trainer.train_step", on_hit=2)) as plan:
        tr.train_step(state, batch)
        with pytest.raises(InjectedFault):
            tr.train_step(state, batch)
    assert plan.triggered == [("trainer.train_step", 2, "raise")]
    assert int(state["step"]) == 1


def test_synchronize_resolves_runtime_device_and_skips_cuda_on_the_cpu(
        monkeypatch):
    """A counted synchronize with no device follows runtime.device: on a
    CPU run it counts the sync and never calls torch.cuda.synchronize."""
    def boom(*a, **k):
        raise AssertionError("torch.cuda.synchronize called on a CPU run")
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    before = tsyncs.total()
    tsyncs.synchronize("test.sync")
    tsyncs.synchronize("test.sync", device="cpu")
    assert tsyncs.total() == before + 2
    x = torch.ones(3)
    assert tsyncs.block_until_ready({"a": x}, "test.wait")["a"] is x
    assert tsyncs.total() == before + 3


def test_device_get_on_the_cpu_returns_copies():
    ring = torch.zeros(2)
    host = tsyncs.device_get({"loss": ring}, "test.copy")
    ring.add_(1)
    assert host["loss"].tolist() == [0.0, 0.0]


def test_meshes_and_sequence_axes_raise():
    """Meshed training runs on gloo ranks (tests/test_torch_trainer_mesh
    .py); here, without a process group, a mesh cannot be built and a
    sequence axis has no mesh to split over."""
    from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(MeshSpec(data=2))
    with pytest.raises(ValueError, match="seq_axis"):
        DistributedTrainer(_linear_loss, sgd(0.1), seq_axis="seq")
    with pytest.raises(ValueError, match="mesh"):
        DeviceEpochCache({"x": np.zeros((8, 1))}, 4, seq_axis="seq")
    with pytest.raises(TypeError, match="nn.Module"):
        DistributedTrainer(_linear_loss, sgd(0.1)).init(lambda: {"w": 0})


def test_trainer_raises_without_cuda_at_the_default_device(monkeypatch):
    monkeypatch.delenv("MMLSPARK_TPU_TORCH_RUNTIME_DEVICE", raising=False)
    tconfig.unset("runtime.device")
    if torch.cuda.is_available():
        pytest.skip("CUDA is available; the check is for a machine without it")
    with pytest.raises(RuntimeError, match="is_available"):
        DistributedTrainer(_linear_loss, sgd(0.1))
