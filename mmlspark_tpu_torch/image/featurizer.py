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
``meshSpec`` goes to the inner ``TorchModel`` (scoring over a mesh of
ranks, ``parallel/leader.py``): each data rank runs the fused uint8 ->
crop/resize/normalize kernel on its rows.
"""
from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.core.params import (
    AnyParam, DictParam, HasInputCol, HasOutputCol, IntParam, StringParam,
)
from mmlspark_tpu_torch.core.pipeline import Transformer
from mmlspark_tpu_torch.core.schema import DType, SchemaError
from mmlspark_tpu_torch.core.serialization import register_stage
from mmlspark_tpu_torch.image.transformer import ImageTransformer, UnrollImage
from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.models.zoo import build_model
from mmlspark_tpu_torch.observability.spans import span

# input frame -> {prep fingerprint: unrolled frame}. Repeat featurization
# of the SAME frame (transfer-learning fit loops, benchmark trials)
# re-did the host resize/unroll AND produced a fresh intermediate frame,
# which also defeated TorchModel's deviceCache (keyed on frame identity).
# Memoizing the prepared frame makes the second pass pure compute: host
# prep skipped, device upload reused. Weak keys: the memo dies with the
# input frame, like models/residency.
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
        return self

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
        the variants scan and the unroll (the general path's host resize
        too), absent on a memo hit."""
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
        if entry is not None and prep_key in entry:
            unrolled, device_pre = entry[prep_key]
        else:
            with span("featurize", "prep", hot=True, rows=frame.count()):
                unrolled, device_pre = self._prepare(frame, in_shape,
                                                     in_dtype, tmp_vec)
            if entry is None:
                # single-frame policy (same as models/residency): a NEW
                # frame evicts other frames' memoized unrolls, bounding
                # host RAM at ~one unrolled dataset, not one per frame
                # ever featurized
                _PREP_CACHE.clear()
                entry = _PREP_CACHE.setdefault(frame, {})
            entry[prep_key] = (unrolled, device_pre)
        # The scoring TorchModel is cached across transform() calls: a
        # fresh one per call would rebuild the net and re-upload its params.
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
        out = tm.transform(unrolled)
        return out.drop(tmp_vec)

    def _prepare(self, frame: Frame, in_shape, in_dtype, tmp_vec: str):
        """(the frame with the unrolled wire column ``tmp_vec``, the
        device preprocess spec: empty when the host resized)."""
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
            unrolled = UnrollImage(inputCol=self.inputCol,
                                   outputCol=tmp_vec,
                                   outputDtype="uint8").transform(frame)
            device_pre = {"srcShape": [int(v) for v in src_shape],
                          "resize": [int(in_shape[0]), int(in_shape[1])]}
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
        return unrolled, device_pre
