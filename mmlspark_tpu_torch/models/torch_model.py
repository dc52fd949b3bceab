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
  ``hidden``, ``logits``);
- token models (``input_dtype="int32"``, the transformer LMs) take an ids
  column, coerced to int32 on the host even from float64; a (B, L, dim)
  output keeps the JAX package's column quirk: its ``dim`` is L.

Everything runs on ``runtime.device`` (``utils/config.py``), which raises
when it names CUDA and there is none. Left for later slices: scoring over
a device mesh (``meshSpec`` must be None) and capturing an unnamed
submodule's output.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Optional

import numpy as np
import torch

from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.core.params import (
    AnyParam, DictParam, HasInputCol, HasOutputCol, IntParam, StringParam,
)
from mmlspark_tpu_torch.core.pipeline import Model
from mmlspark_tpu_torch.core.schema import ColumnSchema, DType, SchemaError
from mmlspark_tpu_torch.core.serialization import register_stage
from mmlspark_tpu_torch.models.convert import from_jax_params
from mmlspark_tpu_torch.models.zoo import build_model, init_state
from mmlspark_tpu_torch.observability import syncs as obssyncs
from mmlspark_tpu_torch.utils.config import resolve_device


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
        "meshSpec", "scoring over a device mesh; not ported yet, must be "
        "None (single-device scoring)", None)
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
    def _spec(self) -> Dict[str, Any]:
        if not self.architecture:
            raise SchemaError("TorchModel: no architecture set; call set_model()")
        return build_model(self.architecture, **self.get("architectureArgs"))

    @property
    def layer_names(self):
        return list(self._spec()["layer_names"])

    def _build_apply(self, device: torch.device):
        """The module on ``device`` with this stage's params, and
        ``apply(x)`` running preprocess + forward (+ layer selection) on
        one device batch."""
        if self.get("meshSpec") is not None:
            raise NotImplementedError(
                "TorchModel: scoring over a device mesh is not ported yet; "
                "leave meshSpec None")
        spec = self._spec()
        module = spec["module"]
        module.load_state_dict(
            {k: torch.from_numpy(np.asarray(v))
             for k, v in self._state["params"].items()}, strict=True)
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
        if node and node not in spec["layer_names"]:
            raise NotImplementedError(
                f"output node {node!r} is not a named layer of "
                f"{self.architecture!r} ({spec['layer_names']}); capturing "
                "other submodule outputs is not ported yet")

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

        if not node:
            forward = module
        else:
            # naming the one layer read lets a model skip what follows it
            # (the LMs' vocab-wide head when only ``hidden`` is asked for)
            forward = lambda x: module.forward_with_intermediates(  # noqa: E731
                x, layers=(node,))[1][node]

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

    def transform(self, frame: Frame) -> Frame:
        device = resolve_device()
        spec = self._spec()
        _, apply = self._cached_build(
            lambda: self._build_apply(device),
            key=(str(device), self.architecture,
                 repr(self.get("architectureArgs")), self.outputNodeName,
                 repr(self.get("devicePreprocess")),
                 repr(self.get("meshSpec")), self.get("computeDtype")))
        bs = self.miniBatchSize
        if self.get("deviceCache") == "on" \
                and getattr(frame, "_out_of_core", False):
            raise ValueError(
                "deviceCache='on' would materialize an out-of-core frame; "
                "score it with deviceCache='auto'/'off' (streams), or "
                "materialize it to an in-memory Frame first if it fits")
        if self.get("deviceCache") != "off" and frame.count():
            dev = self._resident_input(frame, spec, bs, device)
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
                outs.append(obssyncs.device_get(torch.cat(dev_outs),
                                                "transform.retire"))
                dev_outs.clear()

        def flush():
            if not pending:
                return
            stacked = torch.from_numpy(
                np.stack([x for x, _ in pending])).to(device)
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
        return self._emit(frame, outs)

    def _resident_input(self, frame: Frame, spec, bs: int,
                        device: torch.device):
        """The frame's coerced input as a device-resident (steps, bs, ...)
        stack shared across transform calls (and across models with the
        same coercion), or None when over budget with deviceCache='auto'."""
        from mmlspark_tpu_torch.models import residency
        # everything that shapes the coerced stack is part of the key;
        # the architecture stays OUT — identical-input models share
        fingerprint = (self.inputCol, bs, spec.get("input_dtype"),
                       tuple(spec["input_shape"]),
                       repr(self.get("devicePreprocess")))
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
        first = apply(dev[0])
        out_bytes = first.numel() * first.element_size() * steps
        if self.get("deviceCache") == "on" or residency._fits(
                dev.numel() * dev.element_size() + out_bytes):
            out = first.new_empty((steps,) + tuple(first.shape))
            out[0] = first
            for i in range(1, steps):
                out[i] = apply(dev[i])
            host = obssyncs.device_get(out, "transform.resident")
            host = host.reshape((steps * bs,) + host.shape[2:])
            return self._emit(frame, [host[:n_total]])
        window = 32
        dev_outs = [first[:min(bs, n_total)]]
        outs: list = []
        for i in range(1, steps):
            if len(dev_outs) >= window:
                outs.append(obssyncs.device_get(torch.cat(dev_outs),
                                                "transform.retire"))
                dev_outs = []
            dev_outs.append(apply(dev[i])[:min(bs, n_total - i * bs)])
        outs.append(obssyncs.device_get(torch.cat(dev_outs),
                                        "transform.retire"))
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


def _to_float(x: torch.Tensor) -> torch.Tensor:
    """uint8 wire format -> float32 on device; other dtypes untouched
    (int32 token models must stay integer)."""
    return x.float() if x.dtype == torch.uint8 else x
