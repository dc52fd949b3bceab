"""ImageFeaturizer: transfer-learning featurization of image columns.

Re-expression of ``image-featurizer/src/main/scala/ImageFeaturizer.scala:85-128``:
composes (a) resize to the model's input dims, (b) unroll to a vector,
(c) TorchModel scoring with ``cutOutputLayers`` selecting how many layers
to cut off the end — 0 scores the head, 1 emits the pooled feature layer
(the ``layerNames`` contract of the model zoo / downloader schema).

The PyTorch port of ``mmlspark_tpu/image/featurizer.py``: the same uint8
fast path (uniform uint8 images cross to the device raw and are center-
cropped, resized and normalized there by one kernel launch per batch), the
same host-resize fallback, and the same memo of the prepared frame.
A fresh frame of uniform uint8 images whose upload can stay resident takes
the direct route: one scan of the column, then each image copied once into
the featurizer's reused staging stack, which ``TorchModel`` uploads as the
frame's resident input (``featurize.direct_stack`` counts it; every other
fresh frame counts ``featurize.unroll_route`` and takes ``UnrollImage``).
``meshSpec`` goes to the inner ``TorchModel`` (scoring over a mesh of
ranks, ``parallel/leader.py``): each data rank runs the fused uint8 ->
crop/resize/normalize kernel on its rows.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import numpy as np

from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.core.params import (
    AnyParam, DictParam, HasInputCol, HasOutputCol, IntParam, StringParam,
)
from mmlspark_tpu_torch.core.pipeline import Transformer
from mmlspark_tpu_torch.core.schema import DType, SchemaError
from mmlspark_tpu_torch.core.serialization import register_stage
from mmlspark_tpu_torch.image.transformer import ImageTransformer, UnrollImage
from mmlspark_tpu_torch.models import residency
from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.models.zoo import build_model
from mmlspark_tpu_torch.observability import metrics as obsmetrics
from mmlspark_tpu_torch.observability.spans import span

# input frame -> {prep fingerprint: (unrolled frame, or None on the direct
# route, whose upload models/residency keeps; device preprocess spec)}.
# Repeat featurization of the SAME frame (transfer-learning fit loops,
# benchmark trials) re-did the host resize/unroll AND produced a fresh
# intermediate frame, which also defeated TorchModel's deviceCache (keyed
# on frame identity). Memoizing the prepared frame makes the second pass
# pure compute: host prep skipped, device upload reused. Weak keys: the
# memo dies with the input frame, like models/residency.
import weakref  # noqa: E402

_PREP_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


@register_stage
class ImageFeaturizer(HasInputCol, HasOutputCol, Transformer):
    architecture = StringParam("architecture", "model zoo architecture", "")
    architectureArgs = DictParam("architectureArgs",
                                 "architecture constructor kwargs", {})
    cutOutputLayers = IntParam(
        "cutOutputLayers", "how many layers to cut from the end "
        "(0 = head logits, 1 = feature layer)", 1,
        validator=lambda v: v >= 0)
    miniBatchSize = IntParam("miniBatchSize", "scoring batch size", 512)
    meshSpec = AnyParam(
        "meshSpec", "scoring over a mesh of ranks (forwarded to the "
        "internal TorchModel; None = one device)", None)
    computeDtype = StringParam(
        "computeDtype", "backbone compute + feature wire precision "
        "(forwarded to the internal TorchModel): 'bfloat16' runs the "
        "convs/matmuls in bf16 after the float32 preprocess; 'float32' "
        "is exact", "float32",
        domain=("float32", "bfloat16"))

    def __init__(self, uid=None, **kwargs):
        kwargs.setdefault("inputCol", "image")
        kwargs.setdefault("outputCol", "features")
        super().__init__(uid, **kwargs)

    def set_model(self, architecture: str, params=None, seed: int = 0,
                  input_mean=None, input_std=None,
                  **arch_kwargs) -> "ImageFeaturizer":
        """``params``: the JAX package's parameter tree or the port's state
        dict (see :meth:`TorchModel.set_model`); None draws them from
        ``seed``. ``input_mean``/``input_std``: the normalization the net
        was trained with (per-channel or scalar) — applied on device ahead
        of the first layer (TorchModel.set_model owns the plumbing)."""
        self.set_params(architecture=architecture,
                        architectureArgs=dict(arch_kwargs))
        tm = TorchModel()
        tm.set_model(architecture, params=params, seed=seed,
                     input_mean=input_mean, input_std=input_std,
                     **arch_kwargs)
        self._state = {k: v for k, v in tm._state.items()
                       if k in ("params", "input_mu", "input_sigma")}
        self._tm_cache = None  # new params -> stale scoring model
        self.__dict__.pop("_staging_stack", None)
        return self

    def copy(self) -> "ImageFeaturizer":
        other = super().copy()
        other.__dict__.pop("_staging_stack", None)  # a stack of its own
        return other

    def set_model_from_downloader(self, downloader, name: str):
        """The architecture, params and input normalization of model
        ``name`` in ``downloader``'s repository (``models/downloader.py``)."""
        schema = downloader.repo.find_by_name(name)
        return self.set_model(schema.architecture,
                              params=downloader.load_params(name),
                              input_mean=schema.inputMean or None,
                              input_std=schema.inputStd or None,
                              **schema.architectureArgs)

    def transform(self, frame: Frame) -> Frame:
        """The frame with ``outputCol`` added. One hot
        ``transform:ImageFeaturizer`` span; its ``featurize:prep`` covers
        the variants scan and the gather into the staging stack, or the
        unroll (the general path's host resize too), absent on a memo
        hit."""
        with span("transform", "ImageFeaturizer", hot=True):
            return self._transform(frame)

    def _transform(self, frame: Frame) -> Frame:
        if not self.architecture or "params" not in self._get_state():
            raise SchemaError("ImageFeaturizer: call set_model() first")
        spec = build_model(self.architecture, **self.get("architectureArgs"))
        in_shape = spec["input_shape"]
        if len(in_shape) != 3:
            raise SchemaError(
                f"architecture {self.architecture!r} is not an image model")
        layer_names = list(spec["layer_names"])
        cut = self.cutOutputLayers
        if cut >= len(layer_names):
            raise SchemaError(
                f"cutOutputLayers={cut} but model has {len(layer_names)} "
                f"named layers {layer_names}")
        node = "" if cut == 0 else layer_names[-(cut + 1)]

        tmp_vec = frame.schema.find_unused_name("_unrolled")
        in_dtype = frame.schema[self.inputCol].dtype
        prep_key = (self.inputCol, tuple(int(v) for v in in_shape))
        entry = _PREP_CACHE.get(frame)
        memo = entry.get(prep_key) if entry is not None else None
        if memo is not None and memo[0] is None \
                and not self._direct(frame, memo[1], node, tmp_vec):
            memo = None  # the direct route no longer applies: prepare anew
        lease = _Lease(self._staging(), frame, self.inputCol,
                       self.miniBatchSize)
        try:
            if memo is None:
                with span("featurize", "prep", hot=True, rows=frame.count()):
                    unrolled, device_pre = self._prepare(
                        frame, in_shape, in_dtype, tmp_vec, node)
                    if unrolled is None:
                        lease.gather(device_pre["srcShape"])
                if entry is None:
                    # single-frame policy (same as models/residency): a NEW
                    # frame evicts other frames' memoized unrolls, bounding
                    # host RAM at ~one unrolled dataset, not one per frame
                    # ever featurized
                    _PREP_CACHE.clear()
                    entry = _PREP_CACHE.setdefault(frame, {})
                entry[prep_key] = (unrolled, device_pre)
            else:
                # the direct route's memo holds no host copy: the frame's
                # upload stays resident (models/residency); should it have
                # been evicted, the hand-over gathers the frame again
                unrolled, device_pre = memo
            tm = self._scoring_model(node, device_pre, tmp_vec)
            if unrolled is None:
                out = tm.transform_staged(
                    frame, lambda: lease.hand_over(device_pre["srcShape"]),
                    source=self.inputCol)
            else:
                out = tm.transform(unrolled)
        finally:
            lease.release()
        return out.drop(tmp_vec)

    def _scoring_model(self, node: str, device_pre, tmp_vec: str):
        """The scoring TorchModel, cached across transform() calls: a
        fresh one per call would rebuild the net and re-upload its
        params."""
        key = (self.architecture, repr(self.get("architectureArgs")), node,
               self.miniBatchSize, repr(device_pre),
               repr(self.get("meshSpec")), self.get("computeDtype"))
        tm = getattr(self, "_tm_cache", None)
        if tm is None or getattr(self, "_tm_key", None) != key:
            tm = TorchModel(inputCol=tmp_vec, outputCol=self.outputCol,
                          miniBatchSize=self.miniBatchSize,
                          outputNodeName=node,
                          devicePreprocess=device_pre,
                          computeDtype=self.get("computeDtype"),
                          meshSpec=self.get("meshSpec"))
            tm.set_params(architecture=self.architecture,
                          architectureArgs=self.get("architectureArgs"))
            tm._state = {"params": self._state["params"]}
            for k in ("input_mu", "input_sigma"):
                if k in self._state:
                    tm._state[k] = self._state[k]
            self._tm_cache, self._tm_key = tm, key
        else:
            tm.set_params(inputCol=tmp_vec, outputCol=self.outputCol)
        return tm

    def _staging(self) -> "_StagingStack":
        # made on first use: load_stage builds a stage without __init__;
        # setdefault keeps one stack a featurizer when threads race here
        got = self.__dict__.get("_staging_stack")
        return got if got is not None else self.__dict__.setdefault(
            "_staging_stack", _StagingStack())

    def _direct(self, frame: Frame, device_pre, node: str,
                tmp_vec: str) -> bool:
        """Whether a fused-case frame takes the direct route: its upload
        can stay resident (one device, deviceCache not 'off', an in-memory
        frame whose padded stack fits ``runtime.device_cache_mb``), so the
        staging stack is uploaded as the frame's resident input."""
        if self.get("meshSpec") is not None \
                or getattr(frame, "_out_of_core", False):
            return False
        tm = self._scoring_model(node, device_pre, tmp_vec)
        if tm.get("deviceCache") == "off":
            return False
        bs = self.miniBatchSize
        steps = -(-frame.count() // bs)
        return residency._fits(
            steps * bs * int(np.prod(device_pre["srcShape"])))

    def _prepare(self, frame: Frame, in_shape, in_dtype, tmp_vec: str,
                 node: str):
        """(the frame with the unrolled wire column ``tmp_vec``, or None
        when the frame takes the direct route; the device preprocess
        spec: empty when the host resized)."""
        # Fast path — the north-star fusion: when the column holds
        # uniform uint8 HWC images, skip the host resize entirely. Raw
        # uint8 crosses host->device (1/4 the bytes of fp32) and
        # reshape+bilinear-resize+normalize run ON DEVICE as one kernel
        # launch per batch, ahead of the first conv. One pass collects
        # (shape, dtype); the result also answers the general path's
        # wire-format question (binary input decodes to uint8, so only
        # float IMAGE values force the float32 unroll). The scan (and
        # everything after it) runs once per frame: the memo key only
        # needs the input column and target shape.
        variants = ({(v.data.shape, v.data.dtype)
                     for p in frame.partitions
                     for v in p[self.inputCol]}
                    if in_dtype == DType.IMAGE else set())
        all_u8 = (in_dtype != DType.IMAGE
                  or all(dt == np.dtype(np.uint8) for _, dt in variants))
        fused = (len(variants) == 1 and all_u8
                 and len(next(iter(variants))[0]) == 3
                 and next(iter(variants))[0][2] == in_shape[2])
        device_pre = {}
        if fused:
            src_shape = next(iter(variants))[0]
            device_pre = {"srcShape": [int(v) for v in src_shape],
                          "resize": [int(in_shape[0]), int(in_shape[1])]}
            if self._direct(frame, device_pre, node, tmp_vec):
                # the direct route: the scan above already proved the
                # column uniform, so the caller copies each image's bytes
                # once, straight into the padded stack the device takes
                obsmetrics.counter("featurize.direct_stack").inc()
                return None, device_pre
            unrolled = UnrollImage(inputCol=self.inputCol,
                                   outputCol=tmp_vec,
                                   outputDtype="uint8").transform(frame)
        else:
            # General path: ragged sizes / float data / gray images
            # resize on host (batched by shape group), then unroll.
            tmp_img = frame.schema.find_unused_name("_resized")
            resized = ImageTransformer(inputCol=self.inputCol,
                                       outputCol=tmp_img) \
                .resize(in_shape[0], in_shape[1]).transform(frame)
            # uint8 wire format when the data allows it: 4x less
            # host->device traffic; TorchModel casts to float on device.
            # Float image data (user-built ImageValue) keeps the
            # lossless float32 unroll.
            unrolled = UnrollImage(
                inputCol=tmp_img, outputCol=tmp_vec,
                outputDtype="uint8" if all_u8 else "float32") \
                .transform(resized).drop(tmp_img)
        obsmetrics.counter("featurize.unroll_route").inc()
        return unrolled, device_pre


class _StagingStack:
    """A featurizer's host stack of a fresh frame's uint8 images, reused
    across frames so its pages are touched once.

    One ``(steps, miniBatchSize, H*W*C)`` buffer, allocated anew only when
    the batch shape changes or a frame needs more steps than it holds; a
    frame takes its first ``steps`` and zeroes its last batch's pad rows,
    so nothing a larger earlier frame left is read. The buffer stays with
    the featurizer between frames: at most half of
    ``runtime.device_cache_mb`` of host memory (``residency._fits``
    charges a stack twice), dropped by ``set_model``; a copy of the
    featurizer starts without one. ``lock`` guards it while a
    :class:`_Lease` holds it."""

    def __init__(self):
        self.lock = threading.Lock()
        self.buf: Optional[np.ndarray] = None

    def gather(self, frame: Frame, col: str, bs: int,
               shape: Sequence[int]) -> np.ndarray:
        """The ``(steps, bs, prod(shape))`` stack of column ``col``'s
        images (every one of ``shape``, uint8), in row order, tail-padded
        with zeros: what ``UnrollImage`` then ``TorchModel``'s padded
        batches give, copied once. The caller holds ``lock``."""
        n, shape = frame.count(), tuple(int(v) for v in shape)
        steps, dim = -(-n // bs), int(np.prod(shape))
        buf = self.buf
        if buf is None or buf.shape[1:] != (bs, dim) or len(buf) < steps:
            self.buf = buf = None  # the old buffer goes before the new
            buf = self.buf = np.empty((steps, bs, dim), np.uint8)
        stack = buf[:steps]
        rows = stack.reshape(steps * bs, dim)
        off = 0
        for p in frame.partitions:
            vals = p[col]
            if len(vals):
                np.stack([v.data for v in vals],
                         out=rows[off:off + len(vals)].reshape(
                             (len(vals),) + shape))
                off += len(vals)
        rows[off:] = 0
        return stack


class _Lease:
    """One transform's hold on its featurizer's staging stack: held from
    the gather until the frame's synchronous upload, the stack's last
    reader, returns. A memo hit whose upload is still resident never
    takes it."""

    def __init__(self, staging: _StagingStack, frame: Frame, col: str,
                 bs: int):
        self._staging, self._frame, self._col, self._bs = \
            staging, frame, col, bs
        self._stack: Optional[np.ndarray] = None
        self._held = False

    def gather(self, shape: Sequence[int]) -> None:
        """Wait for the stack, then copy the frame's images into it."""
        self._staging.lock.acquire()
        self._held = True
        self._stack = self._staging.gather(self._frame, self._col,
                                           self._bs, shape)

    @contextlib.contextmanager
    def hand_over(self, shape: Sequence[int]):
        """The gathered stack (gathered now if the frame's upload was
        evicted since its prep), given back when the block ends."""
        if self._stack is None:
            self.gather(shape)
        try:
            yield self._stack
        finally:
            self.release()

    def release(self) -> None:
        """Give the stack back; a no-op once given back."""
        if self._held:
            self._stack, self._held = None, False
            self._staging.lock.release()
