"""DeepClassifier and DeepRegressor: the deep-learning Estimators.

The port of ``mmlspark_tpu/train/deep.py``, with the same Params and stage
names (registered with the port's serialization). An Estimator takes a
featurized Frame, trains a zoo architecture with
:class:`~mmlspark_tpu_torch.parallel.trainer.DistributedTrainer` on
``runtime.device``, and returns a fitted model that scores through the
same architecture (the reference's CNTKLearner round trip,
``CNTKLearner.scala:52-162``, in process):

- ``deviceCache`` ``'on'`` / ``'auto'`` keeps the padded epoch resident on
  the device with a per-epoch shuffle on the device
  (``DeviceEpochCache``); ``'off'`` streams host batches in the same
  numpy-shuffled order as the JAX package, through the prefetcher;
- every step has one batch shape: the tail batch is zero-padded and masked
  out of the loss by a per-row weight;
- ``validationSplit`` holds rows out (the reference's per-partition numpy
  split); each epoch evaluates them on the device with one counted fetch,
  and ``earlyStoppingPatience`` stops after that many epochs without
  improvement;
- the fitted ``DeepClassifierModel`` hands out a ``TorchModel`` for
  feature extraction (:meth:`DeepClassifierModel.to_torch_model`).

- ``checkpointDir`` checkpoints every ``checkpointEvery`` steps through
  ``parallel/checkpoint.py::TrainCheckpointer``; a fit over the same
  directory resumes: whole epochs already trained are skipped
  arithmetically, only the partial epoch streams batches past, the
  recorded ``batch_order`` (cached or streamed) pins the mode, early
  stopping's state rides the metadata sidecar, and a fully resumed fit
  runs zero steps. The resumed fit's parameters equal an uninterrupted
  fit's bit for bit.

Every optimizer of the reference trains (``adamw``, ``adam``, ``sgd``,
``lamb``, ``adafactor``; ``parallel/optim.py`` holds optax's rules).

``meshSpec`` (a ``MeshSpec``, an axis-size dict, ``"data=2"`` or a
``DeviceMesh``; None consults the launcher's ``runtime.mesh`` once a
process group is joined, else one device) fits data parallel through the
trainer: every rank runs the fit on the same frame, the batch rounds up
to a multiple of the data ranks (times ``accumSteps``), each rank
uploads its block of every batch, and the weighted loss is the global
batch's (``sharding.global_mean``), as the reference's GSPMD step.
"""
from __future__ import annotations

import inspect
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.core.params import (
    AnyParam, BooleanParam, DictParam, FloatParam, HasFeaturesCol, HasLabelCol,
    IntParam, StringParam,
)
from mmlspark_tpu_torch.core.pipeline import Model
from mmlspark_tpu_torch.core.serialization import register_stage
from mmlspark_tpu_torch.models.zoo import init_state
from mmlspark_tpu_torch.observability import syncs as obssyncs
from mmlspark_tpu_torch.parallel import optim
from mmlspark_tpu_torch.parallel.sharding import global_mean
from mmlspark_tpu_torch.train.learners import (
    FeaturizeHints, TorchEstimator, _pad_xyw, _score_classifier,
    _score_regressor,
)
from mmlspark_tpu_torch.utils.config import resolve_device


def _build_spec(architecture: str, arch_args: Dict[str, Any],
                input_dim: int, n_classes: int,
                train_dtype: str = "") -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Build the zoo spec, injecting input_dim / num_classes (and the
    compute dtype, when ``train_dtype`` is set) where the constructor takes
    them and the caller did not pin them. Returns (spec, resolved args) so
    the fitted model rebuilds the same architecture; dtypes stay strings,
    JSON-serializable in ``architectureArgs``."""
    from mmlspark_tpu_torch.models.zoo import _ZOO, build_model
    args = dict(arch_args or {})
    ctor = _ZOO.get(architecture)
    accepted = set(inspect.signature(ctor).parameters) if ctor else set()
    if "input_dim" in accepted:
        args.setdefault("input_dim", int(input_dim))
    if "num_classes" in accepted:
        args.setdefault("num_classes", int(n_classes))
    if train_dtype and "dtype" in accepted:
        args.setdefault("dtype", train_dtype)
    return build_model(architecture, **args), args


def _train_val_split(frame: Frame, frac: float, seed: int
                     ) -> Tuple[Frame, Frame]:
    """Deterministic per-partition row split (numpy, seeded; both sides
    keep their row order and partitioning), the reference's split."""
    if not frame.schema.names:
        raise ValueError("cannot split an empty-schema frame")
    if getattr(frame, "_out_of_core", False):
        raise ValueError(
            "validationSplit would materialize an out-of-core DiskFrame; "
            "stage separate train/val DiskFrame directories instead")
    rng = np.random.default_rng([seed, 715])
    first = frame.schema.names[0]
    tr_parts, va_parts = [], []
    for p in frame.partitions:
        n = len(p[first])
        k = int(round(n * frac))
        perm = rng.permutation(n)
        va, tr = np.sort(perm[:k]), np.sort(perm[k:])
        tr_parts.append({name: p[name][tr] for name in frame.schema.names})
        va_parts.append({name: p[name][va] for name in frame.schema.names})
    train = Frame(frame.schema, tr_parts)
    val = Frame(frame.schema, va_parts)
    if val.count() < 1 or train.count() < 1:
        raise ValueError(
            f"validationSplit={frac} leaves an empty split of "
            f"{frame.count()} rows")
    return train, val


def _module_with(spec, state_dict: Dict[str, np.ndarray]) -> torch.nn.Module:
    module = spec["module"]
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in state_dict.items()}, strict=True)
    return module


class _DeepEstimatorBase(TorchEstimator):
    """The fit shared by the deep Estimators; subclasses give the task
    head: label dtype, output width, loss and validation sums."""

    hints = FeaturizeHints(one_hot=True, num_features=1 << 12)
    _y_dtype = np.int32

    architecture = StringParam(
        "architecture", "model zoo architecture name", "mlp_tabular")
    architectureArgs = DictParam(
        "architectureArgs", "extra kwargs for the architecture constructor", {})
    batchSize = IntParam("batchSize", "global minibatch size", 256,
                         validator=lambda v: v > 0)
    epochs = IntParam("epochs", "training epochs over the frame", 5,
                      validator=lambda v: v > 0)
    learningRate = FloatParam("learningRate", "peak learning rate", 1e-3)
    weightDecay = FloatParam("weightDecay", "weight decay (adamw/lamb)", 1e-4)
    optimizer = StringParam(
        "optimizer", "optimizer family", "adamw",
        domain=("adamw", "adam", "sgd", "lamb", "adafactor"))
    lrSchedule = StringParam(
        "lrSchedule", "learning-rate schedule over the whole fit: "
        "'constant', 'cosine' (decay to 0), 'linear' (decay to 0); all "
        "start with warmupSteps of linear warmup", "constant",
        domain=("constant", "cosine", "linear"))
    warmupSteps = IntParam("warmupSteps", "linear LR warmup steps", 0,
                           validator=lambda v: v >= 0)
    trainDtype = StringParam(
        "trainDtype", "compute dtype for architectures that accept one "
        "('' = architecture default, typically bfloat16)", "",
        domain=("", "bfloat16", "float32"))
    validationSplit = FloatParam(
        "validationSplit", "fraction of rows held out for per-epoch "
        "validation metrics (0 = off)", 0.0,
        validator=lambda v: 0.0 <= v < 1.0)
    earlyStoppingPatience = IntParam(
        "earlyStoppingPatience", "stop after N epochs without val-loss "
        "improvement (0 = off; requires validationSplit > 0)", 0,
        validator=lambda v: v >= 0)
    accumSteps = IntParam(
        "accumSteps", "gradient-accumulation microbatches per step", 1,
        validator=lambda v: v >= 1)
    remat = BooleanParam("remat", "recompute the forward in the backward",
                         False)
    standardize = BooleanParam(
        "standardize", "z-score features with fit-time statistics", True)
    seed = IntParam("seed", "seed of the init and the batch order", 0)
    meshSpec = AnyParam(
        "meshSpec", "MeshSpec / axis-size dict / DeviceMesh (None = the "
        "launcher's runtime.mesh in a process group, else one device)",
        None)
    checkpointDir = StringParam(
        "checkpointDir", "checkpoint dir for elastic resume ('' = off)", "")
    checkpointEvery = IntParam(
        "checkpointEvery", "save every N steps when checkpointDir is set", 100)
    logEvery = IntParam("logEvery", "log train metrics every N steps (0=off)", 0)
    deviceCache = StringParam(
        "deviceCache", "keep the padded epoch resident on the device and "
        "slice batches there: 'auto' (when it fits runtime.device_cache_mb), "
        "'on', 'off' (stream host batches)", "auto",
        domain=("auto", "on", "off"))

    @classmethod
    def _pad_batch(cls, hb: Dict[str, np.ndarray], fcol: str, lcol: str,
                   bs: int) -> Dict[str, np.ndarray]:
        x, y, w = _pad_xyw(hb, fcol, lcol, bs, cls._y_dtype)
        return {"x": x, "y": y, "w": w}

    def _build_optimizer(self, total_steps: int) -> optim.Optimizer:
        """The optimizer from the optimizer / lrSchedule / warmupSteps
        params (``parallel/optim.py``, optax's rules)."""
        lr = optim.warmup_schedule(self.get("lrSchedule"),
                                   float(self.learningRate),
                                   int(self.warmupSteps), total_steps)
        wd = float(self.weightDecay)
        return {
            "adamw": lambda: optim.adamw(lr, weight_decay=wd),
            "adam": lambda: optim.adam(lr),
            "sgd": lambda: optim.sgd(lr, momentum=0.9),
            "lamb": lambda: optim.lamb(lr, weight_decay=wd),
            "adafactor": lambda: optim.adafactor(lr),
        }[self.get("optimizer")]()

    def _init_params(self, module: torch.nn.Module,
                     seed: int) -> Dict[str, np.ndarray]:
        """The initial state dict of ``module`` (the zoo's seeded init).
        Tests replace it to start from the JAX package's init."""
        return init_state(module, seed)

    # -- task hooks --------------------------------------------------------
    def _n_out(self, frame: Frame, ymax, ymu, ysigma) -> int:
        raise NotImplementedError

    def _make_loss(self, prep, ymu, ysigma):
        raise NotImplementedError

    def _make_val_step(self, prep, ymu, ysigma):
        """(f(module, batch) -> device vector of weighted sums,
        finalize(host sums) -> dict with at least 'val_loss')."""
        raise NotImplementedError

    def _build_fitted(self, fcol, lcol, resolved_args, state_arrays, n_out,
                      ymu, ysigma):
        raise NotImplementedError

    # -- fit ---------------------------------------------------------------
    def fit(self, frame: Frame):
        from mmlspark_tpu_torch.data.prefetch import DevicePrefetcher
        from mmlspark_tpu_torch.train.learners import _epoch_device_cache
        from mmlspark_tpu_torch.utils.logging import MetricLogger
        from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer

        from mmlspark_tpu_torch.parallel.mesh import mesh_shape, resolve_mesh
        from mmlspark_tpu_torch.parallel.sharding import (
            active_batch_axes, whole_state_dict,
        )
        device = resolve_device()
        mesh = resolve_mesh(self.get("meshSpec"))
        fcol, lcol = self.featuresCol, self.labelCol
        self.validation_history = []
        accum = int(self.accumSteps)
        # the batch splits evenly over the data ranks and the microbatches
        dp = math.prod(mesh_shape(mesh)[a] for a in
                       active_batch_axes(mesh) or ()) if mesh else 1
        bs = int(math.ceil(self.batchSize / (dp * accum)) * dp * accum)
        seed = self.seed
        patience = int(self.get("earlyStoppingPatience"))
        val_frac = float(self.get("validationSplit"))
        if patience and not val_frac:
            raise ValueError(
                "earlyStoppingPatience requires validationSplit > 0")
        val_frame = None
        if val_frac:
            frame, val_frame = _train_val_split(frame, val_frac, seed)

        moments = self._streaming_moments(frame)
        if moments[0] == 0:
            raise ValueError(f"{type(self).__name__}: empty frame")
        n, d, mu, sigma, ymax, ymu, ysigma = self._finalize_stats(*moments)
        n_out = self._n_out(frame, ymax, ymu, ysigma)
        spec, resolved_args = _build_spec(
            self.architecture, self.get("architectureArgs"), d, n_out,
            train_dtype=self.get("trainDtype"))
        in_shape = tuple(spec["input_shape"])
        standardize = self.standardize
        mu_d = torch.from_numpy(mu).to(device)
        sigma_d = torch.from_numpy(sigma).to(device)

        def prep(x):
            if standardize:
                x = (x - mu_d) / sigma_d
            if len(in_shape) > 1:
                x = x.reshape((x.shape[0],) + in_shape)
            return x

        steps_per_epoch = math.ceil(n / bs)
        total_steps = steps_per_epoch * self.epochs
        trainer = DistributedTrainer(
            self._make_loss(prep, ymu, ysigma),
            self._build_optimizer(total_steps), mesh=mesh, accum_steps=accum,
            remat=self.remat, device=device)
        def init_fn():
            return _module_with(spec, self._init_params(spec["module"], seed))

        ckpt = None
        if self.checkpointDir:
            from mmlspark_tpu_torch.parallel.checkpoint import (
                TrainCheckpointer,
            )
            ckpt = TrainCheckpointer(self.checkpointDir)
        try:
            if ckpt is not None:
                state, resumed = ckpt.restore_or_init(trainer, init_fn)
            else:
                state, resumed = trainer.init(init_fn), False
            # elastic resume: whole epochs already trained are skipped
            # arithmetically; only the partial epoch streams batches past
            done = 0
            if resumed:
                done = min(int(obssyncs.device_get(state["step"],
                                                   "deep.resume_step")),
                           total_steps)
            start_epoch = done // steps_per_epoch
            skip_in_epoch = done - start_epoch * steps_per_epoch

            # a fully resumed fit runs zero steps: no epoch transfer
            cache = None
            if done < total_steps:
                mode = self.get("deviceCache")
                if resumed:
                    # the two batch-order modes draw different
                    # permutations (numpy on the host, torch on the
                    # device), so a resume in the other mode would replay
                    # or omit rows of the partial epoch: pin the recorded
                    # mode
                    recorded = ckpt.get_meta().get("batch_order")
                    mode = {"streamed": "off", "cached": "on"}.get(recorded,
                                                                   mode)
                cache = None if mode == "off" else _epoch_device_cache(
                    frame, fcol, lcol, bs, self._y_dtype, device=device,
                    seed=seed, force=mode == "on", mesh=mesh)
                if ckpt is not None:
                    ckpt.put_meta(batch_order="cached" if cache is not None
                                  else "streamed")

            def host_batches(epoch):
                """Padded fixed-shape batches of one epoch in the JAX
                package's numpy order (seeded by (seed, epoch)), the
                resumed epoch's finished batches skipped."""
                epoch_rng = np.random.default_rng([seed, epoch])
                for j, hb in enumerate(frame.shuffled_batches(
                        bs, cols=[fcol, lcol], rng=epoch_rng)):
                    if not (epoch == start_epoch and j < skip_in_epoch):
                        yield self._pad_batch(hb, fcol, lcol, bs)

            def cached_batches(epoch):
                for j, b in enumerate(cache.batches(epoch)):
                    if not (epoch == start_epoch and j < skip_in_epoch):
                        yield b

            metric_log = MetricLogger(every=self.logEvery,
                                      name=type(self).__name__)
            val_fn = finalize = None
            val_dev = []
            if val_frame is not None and done < total_steps:
                # the held-out split pads once and stays on the device
                val_fn, finalize = self._make_val_step(prep, ymu, ysigma)
                val_dev = [
                    trainer.put_batch(self._pad_batch(hb, fcol, lcol, bs))
                    for hb in val_frame.batches(bs, cols=[fcol, lcol])]
                val_log = MetricLogger(every=1,
                                       name=type(self).__name__ + ".val")

            best_val, stale, stopped = float("inf"), 0, False
            if resumed:
                # early-stopping state rides the metadata sidecar, so a
                # restart neither trains past a recorded stop nor resets
                # the patience
                es = ckpt.get_meta().get("early_stop") or {}
                best_val = float(es.get("best_val", best_val))
                stale = int(es.get("stale", stale))
                stopped = bool(es.get("stopped", False))
                self.validation_history = list(es.get("history", []))
            step, last_loss = done, None
            for epoch in range(start_epoch, start_epoch if stopped
                               else self.epochs):
                if cache is not None:
                    it, closer = cached_batches(epoch), None
                else:
                    it = closer = DevicePrefetcher(host_batches(epoch),
                                                   trainer.put_batch)
                try:
                    for batch in it:
                        state, metrics = trainer.train_step(state, batch,
                                                            seed)
                        last_loss = metrics["loss"]
                        step += 1
                        metric_log(step, {"loss": last_loss}, batch_rows=bs)
                        if ckpt is not None:
                            ckpt.maybe_save(
                                state, every=self.checkpointEvery, step=step)
                finally:
                    if closer is not None:
                        closer.close()
                if val_fn is not None:
                    module = state["module"]
                    with torch.no_grad(), trainer.mesh_context():
                        # the metric sums accumulate on the device: one
                        # host round trip per epoch
                        sums = trainer.batch_sum(
                            sum(val_fn(module, b) for b in val_dev))
                    vm = finalize(obssyncs.device_get(sums,
                                                      "deep.validation"))
                    val_log(epoch + 1, vm)
                    self.validation_history.append({"epoch": epoch + 1,
                                                    **vm})
                    if vm["val_loss"] < best_val - 1e-12:
                        best_val, stale = vm["val_loss"], 0
                    else:
                        stale += 1
                        stopped = bool(patience and stale >= patience)
                    if ckpt is not None:
                        ckpt.put_meta(early_stop={
                            "best_val": best_val, "stale": stale,
                            "stopped": stopped,
                            "history": self.validation_history})
                    if stopped:
                        break
            if ckpt is not None:
                ckpt.wait()
                if ckpt.latest_step() != step:
                    ckpt.save(state, step=step, wait=True)
            if last_loss is None:
                # fully resumed fit (no step ran): the restored params' loss
                hb = next(iter(frame.batches(bs, cols=[fcol, lcol])))
                last_loss = trainer.eval_step(
                    state,
                    trainer.put_batch(self._pad_batch(hb, fcol, lcol, bs)),
                    seed)

            module = state["module"]
            fetched = obssyncs.device_get(
                {"params": whole_state_dict(module),
                 "final_loss": last_loss}, "deep.fetch_params")
            state_arrays = {
                "params": {k: np.ascontiguousarray(v)
                           for k, v in fetched["params"].items()},
                "mu": mu, "sigma": sigma,
                "standardize": np.asarray(standardize),
                "final_loss": np.asarray(float(fetched["final_loss"])),
                # JSON side of the state: survives save/load
                "validation_history": list(self.validation_history),
            }
            return self._build_fitted(fcol, lcol, resolved_args,
                                      state_arrays, n_out, ymu, ysigma)
        finally:
            if ckpt is not None:
                ckpt.close()


@register_stage
class DeepClassifier(_DeepEstimatorBase):
    """Deep-net classifier (CNTKLearner parity)."""

    def _n_out(self, frame, ymax, ymu, ysigma):
        return self._num_classes(frame, ymax)

    def _make_loss(self, prep, ymu, ysigma):
        def loss_fn(module, batch, gen):
            logits = module(prep(batch["x"])).float()
            ce = F.cross_entropy(logits, batch["y"].long(), reduction="none")
            w = batch["w"]
            return global_mean((ce * w).sum(), w.sum())
        return loss_fn

    def _make_val_step(self, prep, ymu, ysigma):
        def f(module, batch):
            logits = module(prep(batch["x"])).float()
            y = batch["y"].long()
            ce = F.cross_entropy(logits, y, reduction="none")
            w = batch["w"]
            hit = (torch.argmax(logits, dim=-1) == y).float()
            return torch.stack([(ce * w).sum(), (hit * w).sum(), w.sum()])

        def finalize(sums):
            denom = max(float(sums[2]), 1.0)
            return {"val_loss": float(sums[0]) / denom,
                    "val_accuracy": float(sums[1]) / denom}
        return f, finalize

    def _build_fitted(self, fcol, lcol, resolved_args, state_arrays, n_out,
                      ymu, ysigma):
        model = DeepClassifierModel(featuresCol=fcol, labelCol=lcol)
        model.set_params(architecture=self.architecture,
                         architectureArgs=resolved_args)
        model._set_state({**state_arrays,
                          "n_classes": np.asarray(int(n_out))})
        return model


class _FittedDeepModel(HasFeaturesCol, HasLabelCol, Model):
    """What the fitted deep models share: the architecture, the scoring
    preamble, and the per-epoch validation history recorded at fit time
    (kept on the JSON side of the state, so it survives save/load)."""

    architecture = StringParam("architecture", "model zoo architecture", "")
    architectureArgs = DictParam("architectureArgs", "constructor kwargs", {})

    @property
    def validation_history(self):
        return list(self._get_state().get("validation_history", []))

    def _spec(self):
        from mmlspark_tpu_torch.models.zoo import build_model
        return build_model(self.architecture, **self.get("architectureArgs"))

    def _scoring_module(self):
        """(module on ``runtime.device`` in eval mode, preamble): the
        preamble z-scores with the fit-time statistics and reshapes to
        the architecture's input."""
        device = resolve_device()
        spec = self._spec()
        module = _module_with(spec, self._state["params"]).to(device).eval()
        in_shape = tuple(spec["input_shape"])
        standardize = bool(self._state.get("standardize", True))
        mu = torch.from_numpy(np.asarray(self._state["mu"])).to(device)
        sigma = torch.from_numpy(np.asarray(self._state["sigma"])).to(device)

        def pre(x):
            if standardize:
                x = (x - mu) / sigma
            if len(in_shape) > 1:
                x = x.reshape((x.shape[0],) + in_shape)
            return x
        return module, pre


@register_stage
class DeepClassifierModel(_FittedDeepModel):
    """Fitted deep classifier: minibatches through the zoo module;
    ``to_torch_model()`` hands out a TorchModel for feature extraction."""

    def scores_fn(self):
        module, pre = self._scoring_module()

        @torch.inference_mode()
        def f(x):
            logits = module(pre(x)).float()
            return logits, torch.softmax(logits, dim=-1)
        return f

    def transform(self, frame: Frame) -> Frame:
        return _score_classifier(self, frame)

    def to_torch_model(self, output_node: str = "",
                       mini_batch_size: int = 1024):
        """A TorchModel over the trained params, selecting the layer
        ``output_node`` (the ImageFeaturizer / cutOutputLayers hand-off)."""
        from mmlspark_tpu_torch.models.torch_model import TorchModel
        tm = TorchModel(inputCol=self.featuresCol, outputCol="features",
                        miniBatchSize=mini_batch_size,
                        outputNodeName=output_node)
        tm.set_params(architecture=self.architecture,
                      architectureArgs=self.get("architectureArgs"))
        state = {"params": self._state["params"]}
        if bool(self._state.get("standardize", True)):
            # extraction must see the z-scored inputs the net trained on
            in_shape = tuple(self._spec()["input_shape"])
            state["input_mu"] = np.asarray(
                self._state["mu"], np.float32).reshape(in_shape)
            state["input_sigma"] = np.asarray(
                self._state["sigma"], np.float32).reshape(in_shape)
        tm._set_state(state)
        return tm


@register_stage
class DeepRegressor(_DeepEstimatorBase):
    """Deep-net regressor. Targets are z-scored with fit-time statistics so
    the loss is well conditioned; predictions are un-scaled on the way
    out."""

    is_classifier = False
    _y_dtype = np.float32

    def _n_out(self, frame, ymax, ymu, ysigma):
        return 1

    def _make_loss(self, prep, ymu, ysigma):
        ymu_, ysig_ = float(ymu), float(ysigma)

        def loss_fn(module, batch, gen):
            pred = module(prep(batch["x"]))[:, 0].float()
            target = (batch["y"] - ymu_) / ysig_
            w = batch["w"]
            return global_mean((((pred - target) ** 2) * w).sum(), w.sum())
        return loss_fn

    def _make_val_step(self, prep, ymu, ysigma):
        ymu_, ysig_ = float(ymu), float(ysigma)

        def f(module, batch):
            pred = module(prep(batch["x"]))[:, 0].float() * ysig_ + ymu_
            w = batch["w"]
            se = (pred - batch["y"]) ** 2
            return torch.stack([(se * w).sum(), w.sum()])

        def finalize(sums):
            denom = max(float(sums[1]), 1.0)
            return {"val_loss": float(sums[0]) / denom}  # MSE, label units
        return f, finalize

    def _build_fitted(self, fcol, lcol, resolved_args, state_arrays, n_out,
                      ymu, ysigma):
        model = DeepRegressorModel(featuresCol=fcol, labelCol=lcol)
        model.set_params(architecture=self.architecture,
                         architectureArgs=resolved_args)
        model._set_state({**state_arrays, "ymu": np.asarray(float(ymu)),
                          "ysigma": np.asarray(float(ysigma))})
        return model


@register_stage
class DeepRegressorModel(_FittedDeepModel):
    """Fitted deep regressor; predictions un-scaled with the fit-time
    target statistics."""

    def predict_fn(self):
        module, pre = self._scoring_module()
        ymu = float(self._state["ymu"])
        ysigma = float(self._state["ysigma"])

        @torch.inference_mode()
        def f(x):
            return module(pre(x))[:, 0].float() * ysigma + ymu
        return f

    def transform(self, frame: Frame) -> Frame:
        return _score_regressor(self, frame)
