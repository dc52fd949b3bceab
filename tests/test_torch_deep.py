"""The port's DeepClassifier / DeepRegressor, optimizers and schedules,
against the JAX package's on the CPU.

The JAX side runs on a one-device mesh so its sums run in one order; both
sides start from the JAX init (the port's ``_init_params`` seam returns
it, converted by ``from_jax_params``) and, with ``deviceCache="off"``,
see the same rows in the same numpy-shuffled order. Tolerances are stated
at each test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmlspark_tpu.core.frame import Frame as JaxFrame
from mmlspark_tpu.models.zoo import build_model as jax_build_model
from mmlspark_tpu.parallel.mesh import data_parallel_mesh
from mmlspark_tpu.train.deep import DeepClassifier as JaxDeepClassifier
from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.core.serialization import load_stage, save_stage
from mmlspark_tpu_torch.models.convert import from_jax_params
from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.models.zoo import build_model
from mmlspark_tpu_torch.parallel import optim
from mmlspark_tpu_torch.train import deep as tdeep
from mmlspark_tpu_torch.train.deep import (
    DeepClassifier, DeepClassifierModel, DeepRegressor, DeepRegressorModel,
)
from mmlspark_tpu_torch.utils import config as tconfig


@pytest.fixture(autouse=True)
def on_cpu():
    tconfig.set("runtime.device", "cpu")
    yield
    tconfig.unset("runtime.device")


def _xor(n=256, seed=11, d=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = ((X[:, 0] > 0) ^ (X[:, 1] > 0)).astype(np.int64)
    return X, y


def _learner(cls=DeepClassifier, **kw):
    kw.setdefault("architecture", "mlp_tabular")
    kw.setdefault("architectureArgs", {"hidden": [16]})
    kw.setdefault("batchSize", 32)
    kw.setdefault("epochs", 2)
    kw.setdefault("learningRate", 3e-3)
    learner = cls(**kw)
    learner.set_params(featuresCol="features", labelCol="label")
    return learner


def _jax_init(d, seed=0, **arch):
    spec = jax_build_model("mlp_tabular", input_dim=d, **arch)
    params = spec["module"].init(jax.random.PRNGKey(seed), jnp.zeros((1, d)))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("cache", ["off", "on"])
def test_deep_classifier_tracks_jax_epoch_by_epoch(monkeypatch, cache):
    """Two epochs of adamw, fp32, held-out quarter: the per-epoch
    validation loss and accuracy against the JAX package's DeepClassifier
    from the same init. With deviceCache 'off' both stream the same rows
    in the same order (rtol 1e-4: CPU matmuls sum in other orders). With
    'on' each package shuffles its resident epoch with its own generator,
    so the batches differ and only the fit's quality is compared."""
    X, y = _xor()
    kw = dict(architecture="mlp_tabular", architectureArgs={"hidden": [16]},
              batchSize=32, epochs=2, learningRate=3e-3, validationSplit=0.25,
              trainDtype="float32", deviceCache=cache)
    jl = JaxDeepClassifier(meshSpec=data_parallel_mesh(jax.devices()[:1]),
                           **kw)
    jl.set_params(featuresCol="features", labelCol="label")
    jmodel = jl.fit(JaxFrame.from_dict({"features": X, "label": y}))
    jparams = _jax_init(6, hidden=[16], num_classes=2, dtype="float32")
    monkeypatch.setattr(tdeep._DeepEstimatorBase, "_init_params",
                        lambda self, module, seed: from_jax_params(jparams))
    tl = DeepClassifier(**kw)
    tl.set_params(featuresCol="features", labelCol="label")
    tmodel = tl.fit(Frame.from_dict({"features": X, "label": y}))
    want, got = jmodel.validation_history, tmodel.validation_history
    assert [h["epoch"] for h in got] == [h["epoch"] for h in want] == [1, 2]
    if cache == "off":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g["val_loss"], w["val_loss"],
                                       rtol=1e-4)
            assert g["val_accuracy"] == pytest.approx(w["val_accuracy"],
                                                      abs=1 / 64 + 1e-9)
        np.testing.assert_allclose(float(tmodel._state["final_loss"]),
                                   float(jmodel._state["final_loss"]),
                                   rtol=1e-4)
    else:
        assert abs(got[-1]["val_loss"] - want[-1]["val_loss"]) < 0.05


def test_from_jax_params_loads_a_fitted_jax_model():
    """A fitted JAX DeepClassifierModel's flax params load into the port's
    MLP (strict), and the port scores the same logits (fp32, atol 1e-5)."""
    X, y = _xor(n=96, seed=2)
    jl = JaxDeepClassifier(architecture="mlp_tabular",
                           architectureArgs={"hidden": [16, 8]},
                           batchSize=32, epochs=3, trainDtype="float32",
                           meshSpec=data_parallel_mesh(jax.devices()[:1]))
    jl.set_params(featuresCol="features", labelCol="label")
    jm = jl.fit(JaxFrame.from_dict({"features": X, "label": y}))
    sd = from_jax_params(jm._state["params"])
    module = build_model("mlp_tabular", **jm.get("architectureArgs"))["module"]
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                           strict=True)
    mu, sigma = jm._state["mu"], jm._state["sigma"]
    with torch.no_grad():
        got = module(torch.from_numpy((X - mu) / sigma)).numpy()
    want, _ = jm._cached_jit(jm.scores_fn)(X)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


# -- optimizers and schedules against optax ---------------------------------

@pytest.mark.parametrize("opt", ["adamw", "adam", "sgd", "lamb", "adafactor"])
@pytest.mark.parametrize("sched", ["constant", "cosine", "linear"])
def test_optimizer_and_schedule_track_optax(opt, sched):
    """The two packages' DeepClassifier optimizer builders on one
    2-parameter quadratic for 10 updates, 3 of them warm-up, over a
    10-update fit: same rule, same schedule at the count before each
    update. The optimum is far from the start, so every gradient keeps
    its sign and rounding is not amplified; torch and optax round the
    same fp32 operations in other orders, so sgd's parameters are held at
    rtol 1e-6. adam and adamw at rtol 1e-5: optax computes the bias
    correction 1 - b2**t in float32 (1.3e-5 off at t = 1, where 0.999
    rounds to 0.99900001), torch in float64, so each update differs by up
    to ~7e-6 relative. lamb (its bias correction in float32 on both sides)
    and adafactor (one unfactored 2-vector leaf here; the factored rule
    is held below) at rtol 1e-5."""
    c = np.asarray([0.5, 1.5], np.float32)
    t = np.asarray([2.0, -3.0], np.float32)
    kw = dict(optimizer=opt, lrSchedule=sched, warmupSteps=3,
              learningRate=0.05)
    tx = JaxDeepClassifier(**kw)._build_optimizer(10)
    p = jnp.asarray([0.3, -0.7], jnp.float32)
    s = tx.init(p)
    grad = jax.jit(jax.grad(lambda p: (c * (p - t) ** 2).sum()))
    want = []
    for _ in range(10):
        u, s = tx.update(grad(p), s, p)
        p = optax.apply_updates(p, u)
        want.append(np.asarray(p))

    w = torch.nn.Parameter(torch.tensor([0.3, -0.7]))
    st = DeepClassifier(**kw)._build_optimizer(10).init([w])
    ct, tt = torch.from_numpy(c), torch.from_numpy(t)
    got = []
    for _ in range(10):
        (ct * (w - tt) ** 2).sum().backward()
        st.step()
        st.zero_grad()
        got.append(w.detach().numpy().copy())
    np.testing.assert_allclose(np.stack(got), np.stack(want),
                               rtol=1e-6 if opt == "sgd" else 1e-5)
    assert st.count == 10


def _optax_schedule(kind, lr, warm, total):
    """The schedule the JAX DeepClassifier builds
    (``mmlspark_tpu/train/deep.py:229-244``), from optax."""
    total = max(total, warm + 1)
    if kind == "cosine":
        return optax.warmup_cosine_decay_schedule(
            0.0 if warm else lr, lr, warm, total, end_value=0.0)
    if kind == "linear":
        return optax.join_schedules(
            [optax.linear_schedule(0.0, lr, max(warm, 1)),
             optax.linear_schedule(lr, 0.0, total - warm)], [warm])
    if warm:
        return optax.join_schedules(
            [optax.linear_schedule(0.0, lr, warm),
             optax.constant_schedule(lr)], [warm])
    return lambda count: lr


@pytest.mark.parametrize("kind", ["constant", "cosine", "linear"])
@pytest.mark.parametrize("warm", [0, 4])
def test_schedules_match_optax_values(kind, warm):
    """Each schedule's value at every count of a 12-update fit, and past
    it, against optax's (rtol 1e-6: the port computes in float64, optax in
    float32)."""
    want = _optax_schedule(kind, 0.1, warm, 12)
    got = optim.warmup_schedule(kind, 0.1, warm, 12)
    for count in range(14):
        value = got(count) if callable(got) else got
        np.testing.assert_allclose(value, float(want(count)), rtol=1e-6,
                                   atol=1e-9)


def _tree_optimizers(opt, sched, total=10):
    """The JAX and the port's DeepClassifier optimizer for ``opt`` under
    ``sched`` (3 warm-up updates of a ``total``-update fit), lamb with a
    weight decay of 0.1."""
    kw = dict(optimizer=opt, lrSchedule=sched, warmupSteps=3,
              learningRate=0.01, weightDecay=0.1)
    return (JaxDeepClassifier(**kw)._build_optimizer(total),
            DeepClassifier(**kw)._build_optimizer(total))


@pytest.mark.parametrize("opt", ["lamb", "adafactor"])
@pytest.mark.parametrize("sched", ["constant", "cosine", "linear"])
def test_lamb_adafactor_track_optax_on_a_parameter_tree(opt, sched):
    """10 updates of a tree with a factored leaf (256 x 128: both axes
    >= adafactor's ``min_dim_size_to_factor`` 128), an unfactored one (3 x
    200) and a vector (7,), from fixed gradients. The port holds the
    factored leaf transposed, (128, 256), as torch lays out flax's (in,
    out) kernels: the factored rule gives the same update either way. Held
    at rtol 1e-5, with atol 1e-6 for parameters that pass near zero (two
    float32 steps at the largest |p|, ~4: the two frameworks round the
    same float32 operations in other orders; measured at most 4.8e-7)."""
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(256, 128)), "b": rng.normal(size=(3, 200)),
            "c": rng.normal(size=(7,))}
    tree = {k: v.astype(np.float32) for k, v in tree.items()}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in tree.items()} for _ in range(10)]
    tx, recipe = _tree_optimizers(opt, sched)
    p = {k: jnp.asarray(v) for k, v in tree.items()}
    s = tx.init(p)
    for g in grads:
        u, s = tx.update({k: jnp.asarray(v) for k, v in g.items()}, s, p)
        p = optax.apply_updates(p, u)

    layout = {"a": lambda x: x.T, "b": lambda x: x, "c": lambda x: x}
    params = {k: torch.nn.Parameter(torch.from_numpy(
        np.array(layout[k](v), order="C"))) for k, v in tree.items()}
    st = recipe.init(list(params.values()))
    for g in grads:
        for k, w in params.items():
            w.grad = torch.from_numpy(np.array(layout[k](g[k]), order="C"))
        st.step()
        st.zero_grad()
    assert st.count == 10
    for k, w in params.items():
        got = layout[k](w.detach().numpy())
        np.testing.assert_allclose(got, np.asarray(p[k]), rtol=1e-5,
                                   atol=1e-6)
        assert np.abs(got - tree[k]).max() > 1e-3          # it moved


def test_adafactor_factors_only_the_two_largest_axes():
    """optax's ``_factored_dims``: rank >= 2 and the second largest axis at
    least 128; the (second largest, largest) axes."""
    assert optim._factored_dims((256, 128)) == (1, 0)
    assert optim._factored_dims((128, 256)) == (0, 1)
    assert optim._factored_dims((3, 200)) is None
    assert optim._factored_dims((127, 4096)) is None
    assert optim._factored_dims((200,)) is None
    assert optim._factored_dims((3, 3, 256, 128)) == (3, 2)


@pytest.mark.parametrize("opt", ["lamb", "adafactor"])
def test_deep_classifier_lamb_adafactor_track_jax(monkeypatch, opt):
    """``DeepClassifier(optimizer=...)`` trains on the port: two epochs,
    fp32, the hidden 128 x 128 layer factored by adafactor, both packages
    streaming the same rows in the same order (``deviceCache="off"``) from
    the same init; per-epoch validation loss at rtol 1e-4 (CPU matmuls sum
    in other orders), as the adamw fit above."""
    X, y = _xor()
    kw = dict(architecture="mlp_tabular",
              architectureArgs={"hidden": [128, 128]}, batchSize=32,
              epochs=2, learningRate=3e-3, validationSplit=0.25,
              trainDtype="float32", deviceCache="off", optimizer=opt)
    jl = JaxDeepClassifier(meshSpec=data_parallel_mesh(jax.devices()[:1]),
                           **kw)
    jl.set_params(featuresCol="features", labelCol="label")
    jmodel = jl.fit(JaxFrame.from_dict({"features": X, "label": y}))
    jparams = _jax_init(6, hidden=[128, 128], num_classes=2,
                        dtype="float32")
    monkeypatch.setattr(tdeep._DeepEstimatorBase, "_init_params",
                        lambda self, module, seed: from_jax_params(jparams))
    tl = DeepClassifier(**kw)
    tl.set_params(featuresCol="features", labelCol="label")
    tmodel = tl.fit(Frame.from_dict({"features": X, "label": y}))
    want, got = jmodel.validation_history, tmodel.validation_history
    assert [h["epoch"] for h in got] == [1, 2]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["val_loss"], w["val_loss"], rtol=1e-4)
    assert got[-1]["val_loss"] < got[0]["val_loss"] or \
        got[-1]["val_accuracy"] >= got[0]["val_accuracy"]


def test_lamb_adafactor_checkpoint_and_mesh_raise(tmp_path):
    """lamb and adafactor train (above) and checkpoint: with
    ``checkpointDir`` a fit commits its last step, and a refit over the
    same directory runs zero steps and returns the same params (their
    host-side counts ride the checkpoint). A mesh needs a process group
    (its fit runs on gloo ranks in tests/test_torch_trainer_mesh.py), and
    early stopping needs a validation split."""
    X, y = _xor(n=64)
    frame = Frame.from_dict({"features": X, "label": y})
    for name in ("lamb", "adafactor"):
        ckdir = str(tmp_path / name)
        first = _learner(optimizer=name, checkpointDir=ckdir).fit(frame)
        from mmlspark_tpu_torch.parallel.checkpoint import TrainCheckpointer
        assert TrainCheckpointer(ckdir).all_steps() == [4]
        again = _learner(optimizer=name, checkpointDir=ckdir).fit(frame)
        for k, v in first._state["params"].items():
            np.testing.assert_array_equal(again._state["params"][k], v)
    with pytest.raises(RuntimeError, match="process group"):
        _learner(meshSpec={"data": 2}).fit(frame)
    with pytest.raises(ValueError, match="validationSplit"):
        _learner(earlyStoppingPatience=2).fit(frame)


# -- the fitted models -------------------------------------------------------

def test_deep_classifier_fits_scores_and_round_trips(tmp_path):
    """bf16 MLP (the architecture's default), resident epoch: it learns
    the XOR problem, scores every row once (the tail batch is padded and
    masked), and a saved model scores identically after loading."""
    X, y = _xor(n=333, seed=1)
    frame = Frame.from_dict({"features": X, "label": y})
    model = _learner(architectureArgs={"hidden": [32]}, epochs=40,
                     deviceCache="on").fit(frame)
    scored = model.transform(frame)
    pred = scored.column("prediction")
    assert len(pred) == 333
    assert (pred.astype(int) == y).mean() > 0.9
    probs = scored.column("probability")
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-5)
    assert scored.column("rawPrediction").shape == (333, 2)
    save_stage(model, str(tmp_path / "m"))
    loaded = load_stage(str(tmp_path / "m"))
    assert isinstance(loaded, DeepClassifierModel)
    np.testing.assert_array_equal(loaded.transform(frame).column("prediction"),
                                  pred)
    assert loaded.get("architectureArgs") == model.get("architectureArgs")


def test_deep_regressor_unscales_and_round_trips(tmp_path):
    rng = np.random.default_rng(8)
    X = rng.normal(size=(96, 5)).astype(np.float32)
    y = (X @ np.arange(1, 6)).astype(np.float64) + 100.0
    frame = Frame.from_dict({"features": X, "label": y})
    model = _learner(DeepRegressor, epochs=30).fit(frame)
    p1 = model.transform(frame).column("prediction")
    assert abs(np.mean(p1) - 100.0) < 10
    save_stage(model, str(tmp_path / "r"))
    loaded = load_stage(str(tmp_path / "r"))
    assert isinstance(loaded, DeepRegressorModel)
    np.testing.assert_allclose(loaded.transform(frame).column("prediction"),
                               p1)


def test_to_torch_model_extracts_the_pool_features():
    """The TorchModel hand-off scores the same activations the model
    does, standardization included: head(pool) == the model's logits."""
    X, y = _xor(n=64, seed=4, d=8)
    frame = Frame.from_dict({"features": X, "label": y})
    model = _learner(epochs=5, trainDtype="float32").fit(frame)
    tm = model.to_torch_model(output_node="pool", mini_batch_size=32)
    assert isinstance(tm, TorchModel)
    feats = tm.transform(frame).column("features")
    assert feats.shape == (64, 16)
    sd = model._state["params"]
    logits_from_feats = feats @ sd["head.weight"].T + sd["head.bias"]
    logits, _ = model._cached_build(model.scores_fn)(torch.from_numpy(X))
    np.testing.assert_allclose(logits_from_feats, logits.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_early_stopping_stops():
    """learningRate 0 never improves the validation loss after epoch 1:
    the fit stops after 1 + patience epochs, not all 50."""
    X, y = _xor()
    learner = _learner(epochs=50, learningRate=0.0, optimizer="sgd",
                       validationSplit=0.25, earlyStoppingPatience=2)
    model = learner.fit(Frame.from_dict({"features": X, "label": y}))
    assert len(learner.validation_history) == 3
    assert model.validation_history == learner.validation_history


# -- checkpointDir: elastic resume ---------------------------------------------

def _count_steps(monkeypatch):
    """Count train steps and raise InjectedFault at the ``fail_at``-th
    (set later through the returned dict)."""
    from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer
    from mmlspark_tpu_torch.reliability.faults import InjectedFault
    real = DistributedTrainer.train_step
    calls = {"n": 0, "fail_at": None}

    def step(self, state, batch, rng=None):
        calls["n"] += 1
        if calls["n"] == calls["fail_at"]:
            raise InjectedFault("simulated preemption")
        return real(self, state, batch, rng)
    monkeypatch.setattr(DistributedTrainer, "train_step", step)
    return calls


def _params_equal(a, b):
    pa, pb = a._state["params"], b._state["params"]
    assert pa.keys() == pb.keys()
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k])


@pytest.mark.parametrize("cache", ["off", "on"])
def test_checkpoint_resume_skips_finished_epochs_and_equals_uninterrupted(
        tmp_path, monkeypatch, cache):
    """3 epochs of 4 steps, a checkpoint every step, a fault at step 6
    (mid-epoch 2): the refit runs only steps 6..12 (whole epochs skipped,
    the partial one streamed past) and its params equal an uninterrupted
    fit's bit for bit; a third fit over the finished directory runs zero
    steps and returns them again."""
    from mmlspark_tpu_torch.reliability.faults import InjectedFault
    X, y = _xor(n=128, seed=7)
    frame = Frame.from_dict({"features": X, "label": y})
    kw = dict(epochs=3, checkpointEvery=1, deviceCache=cache)
    ref = _learner(checkpointDir=str(tmp_path / "ref"), **kw).fit(frame)
    calls = _count_steps(monkeypatch)
    calls["fail_at"] = 6
    ckdir = str(tmp_path / "ck")
    with pytest.raises(InjectedFault):
        _learner(checkpointDir=ckdir, **kw).fit(frame)
    calls.update(n=0, fail_at=None)
    resumed = _learner(checkpointDir=ckdir, **kw).fit(frame)
    assert calls["n"] == 12 - 5
    _params_equal(ref, resumed)
    np.testing.assert_array_equal(resumed._state["final_loss"],
                                  ref._state["final_loss"])
    calls["n"] = 0
    again = _learner(checkpointDir=ckdir, **kw).fit(frame)
    assert calls["n"] == 0
    _params_equal(ref, again)


def test_checkpoint_resume_pins_the_recorded_batch_order(tmp_path,
                                                         monkeypatch):
    """Interrupt a deviceCache='off' fit, resume with 'auto' (which would
    cache this small frame): the recorded 'streamed' order wins, and the
    result equals the uninterrupted 'off' fit bit for bit."""
    from mmlspark_tpu_torch.parallel.checkpoint import TrainCheckpointer
    from mmlspark_tpu_torch.reliability.faults import InjectedFault
    X, y = _xor(n=128, seed=7)
    frame = Frame.from_dict({"features": X, "label": y})
    kw = dict(epochs=3, checkpointEvery=1)
    ref = _learner(checkpointDir=str(tmp_path / "ref"), deviceCache="off",
                   **kw).fit(frame)
    calls = _count_steps(monkeypatch)
    calls["fail_at"] = 6
    ckdir = str(tmp_path / "ck")
    with pytest.raises(InjectedFault):
        _learner(checkpointDir=ckdir, deviceCache="off", **kw).fit(frame)
    assert TrainCheckpointer(ckdir).get_meta()["batch_order"] == "streamed"
    calls["fail_at"] = None
    resumed = _learner(checkpointDir=ckdir, deviceCache="auto",
                       **kw).fit(frame)
    _params_equal(ref, resumed)


def test_early_stopping_state_survives_a_restart(tmp_path, monkeypatch):
    """With patience 1 the uninterrupted fit stops after some epoch; a fit
    killed in the epoch after its first validation resumes with the
    recorded best loss, stale count and history, and stops at the same
    epoch with the same params and history."""
    from mmlspark_tpu_torch.parallel.checkpoint import TrainCheckpointer
    from mmlspark_tpu_torch.reliability.faults import InjectedFault
    X, y = _xor(n=96, seed=4)
    frame = Frame.from_dict({"features": X, "label": y})
    kw = dict(epochs=8, checkpointEvery=1, validationSplit=0.25,
              earlyStoppingPatience=1, learningRate=0.3, optimizer="sgd",
              deviceCache="off")
    ref = _learner(checkpointDir=str(tmp_path / "ref"), **kw).fit(frame)
    stopped_after = len(ref.validation_history)
    assert stopped_after < 8           # early stopping fired
    calls = _count_steps(monkeypatch)
    calls["fail_at"] = 4              # in epoch 2 (3 steps an epoch)
    ckdir = str(tmp_path / "ck")
    with pytest.raises(InjectedFault):
        _learner(checkpointDir=ckdir, **kw).fit(frame)
    es = TrainCheckpointer(ckdir).get_meta()["early_stop"]
    assert len(es["history"]) == 1 and not es["stopped"]
    calls["fail_at"] = None
    resumed = _learner(checkpointDir=ckdir, **kw).fit(frame)
    assert resumed.validation_history == ref.validation_history
    _params_equal(ref, resumed)
    assert TrainCheckpointer(ckdir).get_meta()["early_stop"]["stopped"]


def test_resumed_fit_tracks_the_jax_fit(tmp_path, monkeypatch):
    """A port fit killed mid-epoch and resumed from its checkpoint ends
    within the epoch-by-epoch test's tolerance (rtol 1e-4) of the JAX
    package's uninterrupted fit from the same init and batch order."""
    from mmlspark_tpu_torch.reliability.faults import InjectedFault
    X, y = _xor(n=128, seed=7)
    kw = dict(architecture="mlp_tabular", architectureArgs={"hidden": [16]},
              batchSize=32, epochs=2, learningRate=3e-3,
              trainDtype="float32", deviceCache="off")
    jl = JaxDeepClassifier(meshSpec=data_parallel_mesh(jax.devices()[:1]),
                           **kw)
    jl.set_params(featuresCol="features", labelCol="label")
    jmodel = jl.fit(JaxFrame.from_dict({"features": X, "label": y}))
    jparams = _jax_init(6, hidden=[16], num_classes=2, dtype="float32")
    monkeypatch.setattr(tdeep._DeepEstimatorBase, "_init_params",
                        lambda self, module, seed: from_jax_params(jparams))
    calls = _count_steps(monkeypatch)
    calls["fail_at"] = 6
    frame = Frame.from_dict({"features": X, "label": y})
    ckdir = str(tmp_path / "ck")
    with pytest.raises(InjectedFault):
        _learner(checkpointDir=ckdir, checkpointEvery=2, **kw).fit(frame)
    calls["fail_at"] = None
    tmodel = _learner(checkpointDir=ckdir, checkpointEvery=2,
                      **kw).fit(frame)
    for k, v in from_jax_params(jmodel._state["params"]).items():
        np.testing.assert_allclose(tmodel._state["params"][k], v,
                                   rtol=1e-4, atol=1e-6)
