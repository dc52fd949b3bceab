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
trainer: the batch rounds up to a multiple of the data ranks (times
``accumSteps``) and the weighted loss is the global batch's
(``sharding.global_mean``), as the reference's GSPMD step. When the mesh
splits the batch over more than one data block, the fit is the
reference's multi-process fit (``mmlspark_tpu/train/deep.py:316-372``):

- the frame is THIS rank's shard (``Frame.process_shard``; ranks of one
  data block pass the same rows), and each rank feeds its
  ``local_batch_rows`` of every global batch (``put_batch(local=True)``);
- the moments are summed over the data blocks
  (:meth:`_DeepEstimatorBase._allreduce_moments`), so the fit-time
  statistics describe the global frame; an empty shard is allowed;
- a shard above its quota (``steps_per_epoch * local_bs`` rows) raises;
- streamed epochs are shuffled per shard, seeded by ``(seed, epoch,
  block)``, and shorter shards fill to the steps of the epoch with
  zero-weight batches, so every rank runs the same steps; validation
  runs the most steps any rank needs, with zero-weight filler too;
- the resident epoch is the local-rows ``DeviceEpochCache``, whose
  verdict every rank shares.

With ``profiling.trace_dir`` set, the fit's epochs run inside
``utils/profiling.trace`` (a ``torch.profiler`` trace).
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

    # -- multi-process -----------------------------------------------------
    @staticmethod
    def _allreduce_moments(moments, group):
        """The streaming moments summed (``ymax``: maxed) over the ranks of
        ``group`` (the data blocks), so fit-time statistics describe the
        GLOBAL frame while each rank scanned only its shard. A header
        exchange agrees on the feature width first, so an empty shard
        (n 0, d unknown) adds zeros; the global-empty case surfaces at the
        caller's ``moments[0] == 0`` check. Differing widths raise on
        every rank (the reference raised on the narrower ones only, and
        left the others waiting in the next gather)."""
        from mmlspark_tpu_torch.parallel.collectives import host_all_gather
        n, d, s, ss, ymax, ysum, ysumsq = moments
        header = np.asarray([n, -1 if d is None else d], np.float64)
        h = np.stack(host_all_gather(header, group))
        d_all = int(h[:, 1].max())
        if d_all < 0:
            return 0, None, None, None, -1, 0.0, 0.0
        widths = sorted({int(w) for w in h[:, 1] if w >= 0})
        if len(widths) > 1:
            raise ValueError(
                f"feature width differs across ranks: {d} vs {d_all} "
                f"(widths {widths})")
        if d is None:
            s, ss = np.zeros(d_all), np.zeros(d_all)
        packed = np.concatenate(
            [np.asarray([n], np.float64), s, ss,
             np.asarray([ymax, ysum, ysumsq], np.float64)])
        g = np.stack(host_all_gather(packed, group))
        return (int(g[:, 0].sum()), d_all, g[:, 1:1 + d_all].sum(axis=0),
                g[:, 1 + d_all:1 + 2 * d_all].sum(axis=0),
                int(g[:, -3].max()), float(g[:, -2].sum()),
                float(g[:, -1].sum()))

    # -- fit ---------------------------------------------------------------
    def fit(self, frame: Frame):
        from mmlspark_tpu_torch.data.prefetch import DevicePrefetcher
        from mmlspark_tpu_torch.train.learners import _epoch_device_cache
        from mmlspark_tpu_torch.utils.logging import MetricLogger
        from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer

        from mmlspark_tpu_torch.parallel.collectives import host_all_gather
        from mmlspark_tpu_torch.parallel.mesh import mesh_shape, resolve_mesh
        from mmlspark_tpu_torch.parallel.sharding import (
            active_batch_axes, axis_group, batch_block, local_batch_rows,
            whole_state_dict,
        )
        from mmlspark_tpu_torch.train.learners import _mesh_group
        from mmlspark_tpu_torch.utils.profiling import trace
        device = resolve_device()
        mesh = resolve_mesh(self.get("meshSpec"))
        fcol, lcol = self.featuresCol, self.labelCol
        self.validation_history = []
        accum = int(self.accumSteps)
        # the batch splits evenly over the data ranks and the microbatches
        axes = (active_batch_axes(mesh) or ()) if mesh else ()
        dp = math.prod(mesh_shape(mesh)[a] for a in axes) if mesh else 1
        bs = int(math.ceil(self.batchSize / (dp * accum)) * dp * accum)
        # more than one data block: each rank holds and feeds its own rows
        # (its local_bs of every global batch)
        spans = dp > 1
        local_bs = local_batch_rows(mesh, bs) if spans else bs
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
        if spans:
            moments = self._allreduce_moments(moments,
                                              axis_group(mesh, axes))
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
        if spans and math.ceil(frame.count() / local_bs) > steps_per_epoch:
            raise ValueError(
                f"rank {torch.distributed.get_rank()} holds {frame.count()} "
                f"rows but its per-epoch quota is "
                f"{steps_per_epoch * local_bs} ({steps_per_epoch} steps x "
                f"{local_bs} local rows); rebalance the per-rank shards "
                "(Frame.process_shard splits evenly)")
        total_steps = steps_per_epoch * self.epochs
        trainer = DistributedTrainer(
            self._make_loss(prep, ymu, ysigma),
            self._build_optimizer(total_steps), mesh=mesh, accum_steps=accum,
            remat=self.remat, device=device)

        def put(batch):
            return trainer.put_batch(batch, local=spans)

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
                    seed=seed, force=mode == "on", mesh=mesh,
                    local_batch=local_bs if spans else None,
                    steps=steps_per_epoch if spans else None)
                if ckpt is not None:
                    ckpt.put_meta(batch_order="cached" if cache is not None
                                  else "streamed")

            def filler():
                return {"x": np.zeros((local_bs, d), np.float32),
                        "y": np.zeros((local_bs,), self._y_dtype),
                        "w": np.zeros((local_bs,), np.float32)}

            def host_batches(epoch):
                """Padded fixed-shape LOCAL batches of one epoch in the JAX
                package's numpy order, seeded by (seed, epoch) and, across
                data blocks, the block; the resumed epoch's finished
                batches skipped. A shard shorter than the epoch fills to
                its steps with zero-weight batches (lockstep)."""
                epoch_rng = np.random.default_rng(
                    [seed, epoch] + ([batch_block(mesh)] if spans else []))
                j = 0
                for hb in frame.shuffled_batches(
                        local_bs, cols=[fcol, lcol], rng=epoch_rng):
                    if not (epoch == start_epoch and j < skip_in_epoch):
                        yield self._pad_batch(hb, fcol, lcol, local_bs)
                    j += 1
                while j < steps_per_epoch:
                    if not (epoch == start_epoch and j < skip_in_epoch):
                        yield filler()
                    j += 1

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
                    put(self._pad_batch(hb, fcol, lcol, local_bs))
                    for hb in val_frame.batches(local_bs,
                                                cols=[fcol, lcol])]
                if spans:
                    # every rank runs the same eval steps: the most any
                    # rank needs, shorter val shards padded with zero
                    # weight
                    val_steps = max(host_all_gather(len(val_dev),
                                                    _mesh_group(mesh)))
                    val_dev += [put(filler())
                                for _ in range(val_steps - len(val_dev))]
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
            with trace():   # a torch.profiler trace iff profiling.trace_dir
                for epoch in range(start_epoch, start_epoch if stopped
                                   else self.epochs):
                    if cache is not None:
                        it, closer = cached_batches(epoch), None
                    else:
                        it = closer = DevicePrefetcher(host_batches(epoch),
                                                       put)
                    try:
                        for batch in it:
                            state, metrics = trainer.train_step(state, batch,
                                                                seed)
                            last_loss = metrics["loss"]
                            step += 1
                            metric_log(step, {"loss": last_loss},
                                       batch_rows=bs)
                            if ckpt is not None:
                                ckpt.maybe_save(state,
                                                every=self.checkpointEvery,
                                                step=step)
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
                        self.validation_history.append(
                            {"epoch": epoch + 1, **vm})
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
                if ckpt.latest_committed(state) != step:
                    ckpt.save(state, step=step, wait=True)
            if last_loss is None:
                # fully resumed fit (no step ran): the restored params' loss
                # (an empty shard evaluates a zero-weight batch)
                hb = next(iter(frame.batches(local_bs, cols=[fcol, lcol])),
                          None)
                last_loss = trainer.eval_step(
                    state, put(filler() if hb is None else
                               self._pad_batch(hb, fcol, lcol, local_bs)),
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
