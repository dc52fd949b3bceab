"""TorchModel: score a zoo network over frame columns, on one torch device.

The port of ``mmlspark_tpu/models/jax_model.py::JaxModel``, with the same
Params and the same behaviour:

- the final minibatch is padded to ``miniBatchSize`` and unpadded after
  scoring (the reference's ``CNTKModel.scala:71-76, 95-97``);
- input coercion Double/Vector -> float32 happens in numpy on the host;
  uint8 stays uint8 on the wire and is cast on the device;
- ``deviceCache`` keeps the coerced input resident on the device across
  transform calls (``models/residency.py``): a whole pass with one output
  fetch when input and output fit the budget, otherwise per-batch scoring
  of the resident stack with outputs retired in windows;
- ``devicePreprocess`` reshapes the flat wire vector to ``srcShape`` and
  center-crops / resizes / normalizes on the device: uint8 input through
  the hand-written crop-resize-normalize kernel (``ops/preprocess.py``),
  float input through the plain torch route;
- ``computeDtype='bfloat16'`` casts float params and activations to
  bfloat16 AFTER the float32 preprocess;
- ``outputNodeName`` selects a named layer (``pool``, ``head``; the LMs'
  ``hidden``, ``logits``) or any other node under the reference's
  capture-all names (``stage3_block2/out``, ``block0/mlp/out``; the
  reference's ``select``: the key or a key ending in ``/node``, first in
  sorted order), captured by a forward hook on that one submodule, in the
  reference's layout (NHWC) and dtype; an unknown node raises
  ``SchemaError``;
- token models (``input_dtype="int32"``, the transformer LMs) take an ids
  column, coerced to int32 on the host even from float64; a (B, L, dim)
  output keeps the JAX package's column quirk: its ``dim`` is L.

- ``meshSpec`` scores over a mesh of ranks (``parallel/leader.py``): rank
  0 leads, ranks 1..n-1 follow; parameters are cut on the host and each
  rank receives only its shards; modules with ``bind_mesh`` compute on
  them (the transformer's tensor split, the MoE's expert banks, the
  DLRM's row-split tables through the fused lookup), other split leaves
  are gathered for their use; the batch goes over the data axes (and,
  for architectures that opt into sequence-parallel attention, the
  sequence over ``seq``), the output is gathered back to rank 0. A mesh
  across hosts, larger than the world, or without a process group
  raises.

Everything runs on ``runtime.device`` (``utils/config.py``), which raises
when it names CUDA and there is none.
"""
from __future__ import annotations

import contextlib
import itertools
import math
from collections.abc import Mapping
from typing import Any, Callable, ContextManager, Dict, Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.core.params import (
    AnyParam, DictParam, HasInputCol, HasOutputCol, IntParam, StringParam,
)
from mmlspark_tpu_torch.core.pipeline import Model
from mmlspark_tpu_torch.core.schema import ColumnSchema, DType, SchemaError
from mmlspark_tpu_torch.core.serialization import register_stage
from mmlspark_tpu_torch.models.convert import from_jax_params
from mmlspark_tpu_torch.models.zoo import build_model, init_state, node_forward
from mmlspark_tpu_torch.observability import syncs as obssyncs
from mmlspark_tpu_torch.observability.spans import span
from mmlspark_tpu_torch.parallel import mesh as meshlib
from mmlspark_tpu_torch.parallel.mesh import mesh_shape
from mmlspark_tpu_torch.utils.config import resolve_device


_STATE_TOKENS = itertools.count()


@register_stage
class TorchModel(HasInputCol, HasOutputCol, Model):
    """Scores a zoo architecture with given params over a vector/image column."""

    architecture = StringParam("architecture", "model zoo architecture name", "")
    architectureArgs = DictParam("architectureArgs",
                                 "kwargs for the architecture constructor", {})
    miniBatchSize = IntParam("miniBatchSize", "rows per device batch", 1024,
                             validator=lambda v: v > 0)
    outputNodeName = StringParam(
        "outputNodeName", "layer to emit ('' = final output)", "")
    devicePreprocess = DictParam(
        "devicePreprocess", "on-device input preprocessing ahead of the "
        "first layer: {'srcShape': [h, w, c], 'crop': [ch, cw], "
        "'resize': [H, W]} reshapes the flat wire vector to srcShape, "
        "center-crops, and bilinear-resizes to the model input ON DEVICE "
        "({} = off; crop/resize each optional). uint8 input runs crop + "
        "resize + requantize + normalize as ONE kernel launch.", {})
    meshSpec = AnyParam(
        "meshSpec", "shard SCORING over a mesh of ranks (MeshSpec / "
        "axis-size dict / 'data=2,tensor=2' / DeviceMesh; None = one "
        "device). Params shard by the standard rules and the batch over "
        "the data axes; rank 0 leads ranks 0..n-1 of the joined world, "
        "all on its host (parallel/leader.py). Persists as an axis-size "
        "dict.", None)
    deviceCache = StringParam(
        "deviceCache", "keep the coerced input resident on the device "
        "across transform calls and slice batches on device: 'auto' "
        "caches when it fits runtime.device_cache_mb, 'on' forces, 'off' "
        "streams.", "auto", domain=("auto", "on", "off"))
    computeDtype = StringParam(
        "computeDtype", "conv/matmul compute precision: 'bfloat16' casts "
        "float params + activations to bf16 after the float32 preprocess; "
        "'float32' keeps full precision. Integer inputs are never cast; "
        "the emitted column is float32.", "float32",
        domain=("float32", "bfloat16"))

    def set_model(self, architecture: str, params: Optional[Any] = None,
                  seed: int = 0, input_mean=None, input_std=None,
                  **arch_kwargs) -> "TorchModel":
        """Attach architecture + params (random-init from ``seed`` if
        params is None).

        ``params`` is either the JAX package's parameter tree (flax
        ``{"params": {...}}``, leaves as numpy) — converted by
        :func:`from_jax_params`, so both packages score the same weights —
        or the port's own flat state dict. ``input_mean``/``input_std``
        (per-channel or scalar) record the normalization the net was
        trained with, applied on the device ahead of the first layer."""
        self.set_params(architecture=architecture,
                        architectureArgs=dict(arch_kwargs))
        spec = build_model(architecture, **arch_kwargs)
        if params is None:
            state_dict = init_state(spec["module"], seed)
        elif any(isinstance(v, Mapping) for v in params.values()):
            state_dict = from_jax_params(params)
        else:
            state_dict = {k: np.asarray(v) for k, v in params.items()}
        state = {"params": state_dict}
        if input_mean is not None or input_std is not None:
            state["input_mu"] = np.asarray(
                input_mean if input_mean is not None else [0.0], np.float32)
            state["input_sigma"] = np.asarray(
                input_std if input_std is not None else [1.0], np.float32)
        # _set_state (not a bare assignment) drops a model built over OLD
        # params
        self._set_state(state)
        return self

    # -- internals ---------------------------------------------------------
    def _spec(self, mesh=None) -> Dict[str, Any]:
        """Build the zoo spec; on a scoring mesh with a ``seq`` axis, the
        ring/Ulysses ``attention_fn`` goes into architectures that OPT IN
        by their spec's ``seq_attention`` flag (the decoder LMs' (q, k, v,
        causal) contract), never into others (a ViT's bidirectional
        attention over an odd token count). An attention_fn is bound to
        the rank's process group and never persists."""
        if not self.architecture:
            raise SchemaError("TorchModel: no architecture set; call set_model()")
        args = dict(self.get("architectureArgs"))
        spec = build_model(self.architecture, **args)
        if mesh is not None and mesh_shape(mesh).get("seq", 1) > 1 \
                and "attention_fn" not in args and spec.get("seq_attention"):
            from mmlspark_tpu_torch.parallel.sequence import make_attention_fn
            args["attention_fn"] = make_attention_fn(mesh, "auto")
            spec = build_model(self.architecture, **args)
        return spec

    # -- scoring over a mesh -----------------------------------------------
    def _mesh_sizes(self) -> Optional[Dict[str, int]]:
        """The scoring mesh's ``{axis: size}`` from ``meshSpec`` (a -1
        absorbs the world's ranks), or None when it is unset or one
        device."""
        spec = self.get("meshSpec")
        if spec is None or spec == "":
            return None
        world = meshlib.world_size()
        if isinstance(spec, DeviceMesh):
            sizes = mesh_shape(spec)
        else:
            if isinstance(spec, str):
                spec = meshlib.parse_mesh_axes(spec)
            if isinstance(spec, dict):
                unknown = sorted(set(spec) - set(meshlib.AXES))
                if unknown:
                    raise ValueError(f"unknown mesh axes {unknown}; valid "
                                     f"axes are {meshlib.AXES}")
                spec = meshlib.MeshSpec(**spec)
            fields = [getattr(spec, a) for a in meshlib.AXES]
            n = world if -1 in fields else math.prod(fields)
            sizes = spec.resolve(n)
        return sizes if math.prod(sizes.values()) > 1 else None

    def _resolve_score_mesh(self):
        """The scoring mesh, or None for the one-device path.

        A mesh of n ranks lies over ranks 0..n-1 of the world, this
        process (rank 0) leading them (``parallel/leader.py``). It needs
        a joined process group of at least n ranks, all on this host:
        scoring is per host, as the reference's is per process."""
        sizes = self._mesh_sizes()
        if sizes is None:
            return None
        from mmlspark_tpu_torch.parallel import leader
        from mmlspark_tpu_torch.parallel.sharding import mesh_spans_hosts
        n = math.prod(sizes.values())
        if not meshlib.is_initialized():
            leader.channel()        # raises, saying how to start ranks
        if n > meshlib.world_size():
            raise ValueError(
                f"TorchModel: a scoring mesh of {n} ranks ({sizes}) in a "
                f"world of {meshlib.world_size()}")
        ch = leader.channel()
        if ch.rank != 0:
            raise RuntimeError(
                "TorchModel: meshed scoring runs on rank 0, the leader; "
                "ranks 1..W-1 run parallel.leader.follow()")
        if mesh_spans_hosts(ch.hosts, range(n)):
            raise SchemaError(
                "TorchModel scoring is per-host; use a mesh of this host's "
                f"ranks (ranks 0..{n - 1} run on {sorted(set(ch.hosts[:n]))})")
        return ch.mesh(sizes)

    def _placement_key(self, mesh) -> str:
        """One placement per (model copy, mesh, what the closure bakes):
        a copy is its state object, named by a token of its own (an id
        could come back for a later state while a placement lives)."""
        held = getattr(self, "_state_token", None)
        if held is None or held[0] is not self._state:
            held = self._state_token = (self._state, next(_STATE_TOKENS))
        return repr((held[1], mesh_shape(mesh), self.outputNodeName,
                     repr(self.get("devicePreprocess")),
                     self.get("computeDtype")))

    def _host_params(self) -> Dict[str, torch.Tensor]:
        """The state dict on the host as tensors, cast to bf16 here when
        that is the compute dtype (the reference's host-side cast), so no
        rank ever receives a float32 leaf it would cast itself."""
        cdt = self.get("computeDtype") == "bfloat16"
        out = {}
        for k, v in self._state["params"].items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = t.to(torch.bfloat16) if cdt and t.is_floating_point() \
                else t
        return out

    def _build_meshed(self, device: torch.device, mesh):
        """``(module, apply)`` over ``mesh``: the leader's module holds
        rank 0's shards, and ``apply(x)`` scores a padded HOST batch on
        every rank of the mesh and returns the whole output on this
        device."""
        from mmlspark_tpu_torch.parallel import leader
        ch = leader.channel()
        recipe = {"params": {k: v for k, v in
                             self.explicit_param_values().items()
                             if k != "meshSpec"},
                  "state": {k: v for k, v in self._state.items()
                            if k != "params"}}
        key = self._placement_key(mesh)
        seq = bool(mesh_shape(mesh).get("seq", 1) > 1
                   and self._spec().get("seq_attention"))
        placement = ch.acquire(
            key, mesh_shape(mesh), "mmlspark_tpu_torch.models.torch_model:"
            "_mesh_part", recipe, self._host_params(),
            seq_axis="seq" if seq else None)
        return placement.module, MeshedApply(ch, placement, seq)

    def release_placement(self) -> None:
        """Drop the memoized meshed apply and its reference to the
        placement (the last reference frees it on every rank)."""
        cached = getattr(self, "_build_cache", None)
        self._build_cache = None
        if cached is not None and isinstance(cached[1][1], MeshedApply):
            cached[1][1].release()

    def _set_state(self, state: Dict[str, Any]) -> None:
        self.release_placement()
        super()._set_state(state)

    @property
    def layer_names(self):
        return list(self._spec()["layer_names"])

    def _build_apply(self, device: torch.device):
        """The module on ``device`` with this stage's params, and
        ``apply(x)`` running preprocess + forward (+ layer selection) on
        one device batch."""
        spec = self._spec()
        module = spec["module"]
        module.load_state_dict(
            {k: torch.from_numpy(np.asarray(v))
             for k, v in self._state["params"].items()}, strict=True)
        return self._make_apply(module.to(device), spec, device)

    def _make_apply(self, module, spec, device: torch.device):
        """``(module, apply)``: ``module`` (its params already on
        ``device``) in eval mode and the compute dtype, and ``apply(x)``
        running preprocess + forward (+ layer selection) on one batch."""
        cdt = (torch.bfloat16 if self.get("computeDtype") == "bfloat16"
               else None)
        module = module.to(device).eval()
        if cdt is not None:
            module = module.to(cdt)
        if device.type == "cuda":
            # the convs take NHWC views of the input; keep the weights in
            # the same memory format so cuDNN does not transpose them per call
            module = module.to(memory_format=torch.channels_last)
        node = self.outputNodeName
        if not node:
            forward = module
        elif node in spec["layer_names"]:
            # naming the one layer read lets a model skip what follows it
            # (the LMs' vocab-wide head when only ``hidden`` is asked for)
            forward = lambda x: module.forward_with_intermediates(  # noqa: E731
                x, layers=(node,))[1][node]
        else:
            # any other node: the reference's select over its capture-all
            # names, one forward hook on the submodule it picks
            forward = node_forward(module, node)

        # Optional input standardization: models trained on z-scored inputs
        # carry fit-time statistics so scoring sees the same distribution
        # the net was trained on. Shapes must broadcast against the input.
        dp = self.get("devicePreprocess")
        mu = self._state.get("input_mu")
        fused = None
        if dp:
            src = tuple(int(v) for v in dp["srcShape"])
            dst = tuple(int(v) for v in dp.get("resize") or ())
            crop = tuple(int(v) for v in dp.get("crop") or ()) or None

            from mmlspark_tpu_torch.ops.preprocess import (
                device_resize_bilinear, make_fused_preprocess_fn,
            )

            # scalar / per-channel normalization folds INTO the kernel;
            # anything wider (a full-image mean) takes the plain route below
            mean_a = (np.asarray(mu, np.float32).ravel()
                      if mu is not None else np.zeros(1, np.float32))
            std_a = (np.asarray(self._state["input_sigma"],
                                np.float32).ravel()
                     if mu is not None else np.ones(1, np.float32))
            # the kernel stores in the compute dtype itself: its bf16 store
            # rounds the same fp32 value a cast would, with no second pass
            if mean_a.size in (1, src[2]) and std_a.size in (1, src[2]):
                fused = make_fused_preprocess_fn(
                    src, resize=dst or None, crop=crop, mean=mean_a,
                    std=std_a, out_dtype=cdt or torch.float32)

            def base(x):
                was_u8 = x.dtype == torch.uint8
                x = _to_float(x.reshape((x.shape[0],) + src))
                if crop:
                    oh = (src[0] - crop[0]) // 2
                    ow = (src[1] - crop[1]) // 2
                    x = x[:, oh:oh + crop[0], ow:ow + crop[1]]
                if dst and dst != (crop or src[:2]):
                    x = device_resize_bilinear(x, dst[0], dst[1])
                    if was_u8:
                        # the host path's uint8 re-quantization
                        x = x.round().clamp(0.0, 255.0)
                return x
        else:
            base = _to_float

        if mu is not None:
            mu_d = torch.from_numpy(np.asarray(mu, np.float32)).to(device)
            sigma_d = torch.from_numpy(
                np.asarray(self._state["input_sigma"], np.float32)).to(device)
            norm = lambda x: (base(x) - mu_d) / sigma_d  # noqa: E731
        else:
            norm = base

        def pre(x):
            # uint8 wire input runs the one kernel; float input — the
            # lossless path — keeps the plain route, numerically the same
            # pipeline
            y = fused(x) if fused is not None and x.dtype == torch.uint8 \
                else norm(x)
            # bf16 enters HERE, after the full-precision preprocess (the
            # fused kernel's output already is; the cast is then a no-op);
            # integer token inputs pass through untouched
            if cdt is not None and y.is_floating_point():
                y = y.to(cdt)
            return y

        @torch.inference_mode()
        def apply(x: torch.Tensor) -> torch.Tensor:
            return forward(pre(x))

        return module, apply

    def _coerce_batch(self, arr: np.ndarray, spec) -> np.ndarray:
        """Host-side input coercion (reference UDFs :195-212) + reshape.
        uint8 inputs stay uint8 — they cross host->device at 1/4 the bytes
        and are cast on the device (the fused-preprocess fast path)."""
        want_int = spec.get("input_dtype") == "int32"
        arr = np.asarray(arr)
        if arr.dtype != np.uint8 or want_int:
            arr = arr.astype(np.int32 if want_int else np.float32)
        dp = self.get("devicePreprocess")
        if dp:
            # the device reshapes/resizes; ship the flat wire vector
            want = int(np.prod(dp["srcShape"]))
            if arr.ndim != 2 or arr.shape[1] != want:
                raise SchemaError(
                    f"devicePreprocess srcShape {dp['srcShape']} wants flat "
                    f"width {want}, got {arr.shape}")
            return arr
        in_shape = tuple(spec["input_shape"])
        if arr.ndim == 2 and len(in_shape) > 1:
            if int(np.prod(in_shape)) != arr.shape[1]:
                raise SchemaError(
                    f"input width {arr.shape[1]} != prod{in_shape}")
            arr = arr.reshape((arr.shape[0],) + in_shape)
        return arr

    def _padded_batches(self, frame: Frame, spec, bs: int):
        """(coerced host batch padded to ``bs`` rows, valid rows)."""
        for batch in frame.batches(bs, cols=[self.inputCol]):
            x = self._coerce_batch(batch[self.inputCol], spec)
            n = x.shape[0]
            if n < bs:  # pad final batch: one batch shape for the whole pass
                pad = np.zeros((bs - n,) + x.shape[1:], x.dtype)
                x = np.concatenate([x, pad], axis=0)
            yield x, n

    def _device_apply(self, device: torch.device):
        """``(module, apply)`` on ``device``, built once and memoized under
        everything the closure bakes in; the serving registry shares it
        with ``transform``. On a scoring mesh ``apply`` is a
        :class:`MeshedApply` taking padded host batches."""
        mesh = self._resolve_score_mesh()
        return self._cached_build(
            (lambda: self._build_apply(device)) if mesh is None
            else (lambda: self._build_meshed(device, mesh)),
            key=(str(device), self.architecture,
                 repr(self.get("architectureArgs")), self.outputNodeName,
                 repr(self.get("devicePreprocess")),
                 repr(self.get("meshSpec")), self.get("computeDtype")))

    def transform(self, frame: Frame) -> Frame:
        """The frame with ``outputCol`` added. One hot
        ``transform:TorchModel`` span; inside it ``score:stack`` (the
        coerced, padded host stack), ``score:upload`` (its copy to the
        device), ``score:launch`` (the apply loop), ``score:fetch`` (each
        counted fetch; inside ``score:launch`` where outputs retire in
        windows) and ``score:emit`` (the output column)."""
        with span("transform", "TorchModel", hot=True):
            return self._transform(frame)

    def transform_staged(self, frame: Frame,
                         stage: Callable[[], ContextManager[np.ndarray]],
                         source: str) -> Frame:
        """:meth:`transform` of ``frame`` from a host stack its caller
        gathered from column ``source``, for a one-device model with
        ``deviceCache`` not 'off'. ``stage()`` is a context manager that
        hands over the coerced, tail-padded ``(steps, bs, ...)`` stack
        that ``_padded_batches`` would give, which the caller has checked
        against the device budget, and frees it on exit. It is entered
        only when the frame's resident upload is missing, in
        ``score:stack``, and left as soon as the upload returns. The same
        spans as :meth:`transform`."""
        with span("transform", "TorchModel", hot=True):
            return self._transform(frame, (stage, source))

    def _transform(self, frame: Frame, staged=None) -> Frame:
        device = resolve_device()
        spec = self._spec()
        _, apply = self._device_apply(device)
        bs = self.miniBatchSize
        if isinstance(apply, MeshedApply):
            return self._transform_sharded(frame, spec, apply, bs)
        if self.get("deviceCache") == "on" \
                and getattr(frame, "_out_of_core", False):
            raise ValueError(
                "deviceCache='on' would materialize an out-of-core frame; "
                "score it with deviceCache='auto'/'off' (streams), or "
                "materialize it to an in-memory Frame first if it fits")
        if staged is not None or (self.get("deviceCache") != "off"
                                  and frame.count()):
            dev = self._resident_input(frame, spec, bs, device, staged)
            if dev is not None:
                return self._transform_resident(frame, apply, dev, bs)
        # Streaming loop. Transfers are batched: ``put_window`` minibatches
        # stack into ONE host->device copy, then each batch is a device
        # slice. Outputs retire in bounded windows: one device-side concat
        # + ONE fetch per window, without accumulating the whole output
        # (which for intermediate-layer extraction is not small).
        put_window = 8         # minibatches per host->device copy
        window = 32            # output batches fetched per round trip
        dev_outs: list = []
        outs: list = []
        pending: list = []     # coerced host batches awaiting one copy

        def retire():
            if dev_outs:
                outs.append(_fetch(torch.cat(dev_outs), "transform.retire"))
                dev_outs.clear()

        def flush():
            if not pending:
                return
            with span("score", "stack", hot=True):
                host = np.stack([x for x, _ in pending])
            with span("score", "upload", hot=True, bytes=host.nbytes):
                stacked = torch.from_numpy(host).to(device)
            with span("score", "launch", hot=True, batches=len(pending)):
                for i, (_, n) in enumerate(pending):
                    dev_outs.append(apply(stacked[i])[:n])
                    if len(dev_outs) >= window:
                        retire()
            pending.clear()

        for x, n in self._padded_batches(frame, spec, bs):
            pending.append((x, n))
            if len(pending) >= put_window:
                flush()
        flush()
        retire()
        with span("score", "emit", hot=True):
            return self._emit(frame, outs)

    def _resident_input(self, frame: Frame, spec, bs: int,
                        device: torch.device, staged=None):
        """The frame's coerced input as a device-resident (steps, bs, ...)
        stack shared across transform calls (and across models with the
        same coercion), or None when over budget with deviceCache='auto'.
        ``staged``: ``transform_staged``'s (stage, source)."""
        from mmlspark_tpu_torch.models import residency
        # everything that shapes the coerced stack is part of the key;
        # the architecture stays OUT — identical-input models share
        fingerprint = (self.inputCol, bs, spec.get("input_dtype"),
                       tuple(spec["input_shape"]),
                       repr(self.get("devicePreprocess")))
        if staged is not None:
            stage, source = staged
            # the model's inputCol is the caller's temporary name, alike
            # for every column of the frame: the key names the source
            fingerprint += ("staged", source)
            with contextlib.ExitStack() as held:
                def build() -> np.ndarray:
                    host = held.enter_context(stage())
                    # a copy to the host device would alias the caller's
                    # reused stack, so there the resident input is a copy
                    return host if device.type != "cpu" else host.copy()
                # leaving the block frees the stack: the upload returned
                return residency.resident_batches(frame, fingerprint, build,
                                                  device, force=True)
        # size hint from one coerced row, so an over-budget frame is
        # rejected before build() materializes a full-dataset host copy
        steps = int(np.ceil(frame.count() / bs))
        head = self._coerce_batch(
            np.asarray([np.asarray(frame.head(1)[0][self.inputCol])]), spec)
        hint = steps * bs * head[0].nbytes

        def build() -> np.ndarray:
            return np.stack([x for x, _ in
                             self._padded_batches(frame, spec, bs)])

        return residency.resident_batches(
            frame, fingerprint, build, device,
            force=self.get("deviceCache") == "on", nbytes_hint=hint)

    @torch.inference_mode()
    def _transform_resident(self, frame: Frame, apply, dev: torch.Tensor,
                            bs: int) -> Frame:
        """Score from the resident (steps, bs, ...) stack. When the whole
        output stack fits the budget beside the input (or deviceCache is
        'on'), every batch writes into one device output tensor and the
        pass ends in ONE fetch; otherwise outputs retire in windows. Pad
        rows sit at the tail of the last batch, so one flat slice drops
        them."""
        from mmlspark_tpu_torch.models import residency
        n_total = frame.count()
        steps = dev.shape[0]
        with span("score", "launch", hot=True, batches=steps):
            first = apply(dev[0])
            out_bytes = first.numel() * first.element_size() * steps
            whole = self.get("deviceCache") == "on" or residency._fits(
                dev.numel() * dev.element_size() + out_bytes)
            if whole:
                out = first.new_empty((steps,) + tuple(first.shape))
                out[0] = first
                for i in range(1, steps):
                    out[i] = apply(dev[i])
            else:
                window = 32
                dev_outs = [first[:min(bs, n_total)]]
                outs: list = []
                for i in range(1, steps):
                    if len(dev_outs) >= window:
                        outs.append(_fetch(torch.cat(dev_outs),
                                           "transform.retire"))
                        dev_outs = []
                    dev_outs.append(apply(dev[i])[:min(bs, n_total - i * bs)])
        if whole:
            host = _fetch(out, "transform.resident")
            outs = [host.reshape((steps * bs,) + host.shape[2:])[:n_total]]
        else:
            outs.append(_fetch(torch.cat(dev_outs), "transform.retire"))
        with span("score", "emit", hot=True):
            return self._emit(frame, outs)

    def _transform_sharded(self, frame: Frame, spec, apply: "MeshedApply",
                           bs: int) -> Frame:
        """The meshed scoring loop: each padded host batch (its rows a
        multiple of the data ranks, the ragged tail padded and cut) is
        scored by every rank of the mesh on its block, and the gathered
        output fetched once a batch."""
        from mmlspark_tpu_torch.parallel.sharding import batch_share
        _, total = batch_share(apply.placement.mesh)
        bs = int(np.ceil(bs / total) * total)
        outs = [obssyncs.device_get(apply(x), "transform.sharded")[:n]
                for x, n in self._padded_batches(frame, spec, bs)]
        return self._emit(frame, outs)

    def _emit(self, frame: Frame, outs: list) -> Frame:
        """Fetched output batches -> the scored frame column.

        On the single-batch path the emitted column ALIASES ``outs[0]``
        (no copy when it is already 2-D float32); every caller hands over
        freshly fetched buffers."""
        if not outs:
            out = np.zeros((0, 1), np.float32)
        elif len(outs) == 1:
            out = outs[0]
        else:
            out = np.concatenate(outs, axis=0)
        if out.ndim == 1:
            out = out[:, None]
        out = np.asarray(out, np.float32)   # no-copy when already fp32
        col = ColumnSchema(self.outputCol, DType.VECTOR, int(out.shape[1]),
                           metadata={"model_uid": self.uid,
                                     "architecture": self.architecture})
        return frame.with_column_values(col, out)

    def transform_schema(self, schema):
        return schema.add(ColumnSchema(self.outputCol, DType.VECTOR, None))


class MeshedApply:
    """The leader's apply over a scoring mesh: ``apply(x)`` sends the
    padded host batch ``x`` to every rank of the placement, each scores
    its block of rows (and, under ``seq``, its slice of the sequence) on
    its shards, and the output is gathered over the data (and sequence)
    ranks onto the leader's device. ``prog`` names the serving program
    calling it, under which each rank counts its kernel launches."""

    meshed = True

    def __init__(self, ch, placement, seq: bool):
        self.channel = ch
        self.placement = placement
        self.seq = seq
        self.released = False

    def __call__(self, x: np.ndarray, prog: Optional[str] = None
                 ) -> torch.Tensor:
        from mmlspark_tpu_torch.parallel.sharding import batch_share
        x = np.asarray(x)
        n = x.shape[0]
        # a batch the data ranks cannot split evenly (a serving bucket of
        # one row) is padded to a multiple of them, and the pad cut
        total = batch_share(self.placement.mesh)[1]
        if n % total:
            x = np.concatenate([x, np.zeros((total - n % total,)
                                            + x.shape[1:], x.dtype)])
        out = self.channel.call(
            "mmlspark_tpu_torch.models.torch_model:_mesh_score",
            {"key": self.placement.key, "seq": self.seq, "prog": prog},
            [x], n=self.placement.mesh.size())
        return out[:n]

    def rank_launches(self, prog: str) -> list:
        """Each rank's kernel launches under program ``prog``."""
        return self.channel.rank_launches(self.placement.key, prog)

    @property
    def mesh_key(self) -> str:
        """The placement's identity in program and cache keys."""
        return ",".join(f"{a}={n}" for a, n in
                        mesh_shape(self.placement.mesh).items() if n > 1)

    def acquire(self) -> "MeshedApply":
        """One more reference to the placement (a serving entry's)."""
        with self.channel.lock:
            self.channel.refs[self.placement.key] += 1
        return self

    def release(self) -> None:
        self.channel.release(self.placement.key)


def _mesh_part(recipe: Dict[str, Any], mesh):
    """The placement builder of a meshed ``TorchModel`` (run on every
    rank): the module from the recipe's params on the host, and the
    finish that makes ``(stage, apply)`` once its shards are placed."""
    tm = TorchModel()
    tm.set_params(**recipe["params"])
    tm._state = dict(recipe["state"])
    spec = tm._spec(mesh)
    return spec["module"], lambda module, device: (
        tm, tm._make_apply(module, spec, device)[1])


def _mesh_score(ch, header, tensors, local):
    """One meshed scoring command on this rank: its rows (and sequence
    slice) of the global batch through its shards, the output gathered
    over the sequence, vocabulary and data ranks (the leader's return
    value is the whole output)."""
    from mmlspark_tpu_torch.parallel import collectives, sharding
    pl = ch.placements[header["key"]]
    layout = pl.layout
    tm, apply = pl.parts
    x = sharding.local_rows(pl.mesh, tensors[0].numpy())  # lint: allow-sync (host operand)
    if header["seq"]:
        x = sharding.local_seq(pl.mesh, x, "seq")
    x = torch.from_numpy(np.ascontiguousarray(x)).to(pl.device)

    def run():
        with pl.using() as module:
            out = apply(x)
            vocab = getattr(module, "_vocab", None)
            if vocab is not None and tm.outputNodeName in ("", "logits", "head"):
                out = collectives.all_gather(out, out.dim() - 1, vocab)
            if header["seq"]:
                out = collectives.all_gather(out, 1, layout.group("seq"))
            return collectives.all_gather(out, 0,
                                          layout.group(*layout.batch_axes))
    return pl.counted(header.get("prog"), run)


def _fetch(x: torch.Tensor, site: str) -> np.ndarray:
    """A counted fetch of ``x`` in a hot ``score:fetch`` span."""
    with span("score", "fetch", hot=True,
              bytes=x.numel() * x.element_size()):
        return obssyncs.device_get(x, site)


def _to_float(x: torch.Tensor) -> torch.Tensor:
    """uint8 wire format -> float32 on device; other dtypes untouched
    (int32 token models must stay integer)."""
    return x.float() if x.dtype == torch.uint8 else x
