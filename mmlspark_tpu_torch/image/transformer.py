"""ImageTransformer + UnrollImage: declarative per-row image pipelines.

Re-expression of ``image-transformer/src/main/scala/ImageTransformer.scala``:
the stage list is a JSON-able param (the reference's ArrayMapParam), stages
apply in order per image, and the transformer accepts image OR raw binary
input (decoding first, ``transform`` ``:272-304``).

UnrollImage converts an image row to a flat float32 vector
(``UnrollImage.scala:18-42``). Deliberate difference: unroll order is HWC
(the layout the models take at their input) rather than the reference's
CHW, and the uint8->float conversion needs no sign fixup because the bytes
never pass through a signed JVM byte array.

Placement decision: these stages run on HOST (vectorized numpy, shape-
grouped batching) because their contract is host-value -> host-value — a
device round trip per stage would pay host->device->host twice for
elementwise work. The DEVICE version of the hot path (resize + requantize
+ normalize) lives where a consumer can run it ahead of its first layer:
TorchModel's ``devicePreprocess`` / ``ops.preprocess``, which
ImageFeaturizer routes uniform uint8 inputs through automatically — same
half-pixel and uint8-rounding semantics, pinned by tests, so host and
device paths are interchangeable.

This is the PyTorch port's copy of ``mmlspark_tpu/image/transformer.py``;
binary input decodes through the port's ``io/codecs.py``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.core.params import (
    HasInputCol, HasOutputCol, ListParam, StringParam,
)
from mmlspark_tpu_torch.core.pipeline import Transformer
from mmlspark_tpu_torch.core.schema import ColumnSchema, DType, ImageValue, SchemaError
from mmlspark_tpu_torch.core.serialization import register_stage
from mmlspark_tpu_torch.image import ops
from mmlspark_tpu_torch.io.codecs import decode_image

STAGE_REGISTRY = {
    "resize": lambda img, p: ops.resize(img, p["height"], p["width"]),
    "crop": lambda img, p: ops.crop(img, p["x"], p["y"], p["height"], p["width"]),
    "centercrop": lambda img, p: ops.center_crop(img, p["height"], p["width"]),
    "colorformat": lambda img, p: ops.color_format(img, p["format"]),
    "blur": lambda img, p: ops.blur(img, p["height"], p["width"]),
    "threshold": lambda img, p: ops.threshold(
        img, p["threshold"], p["maxVal"], p.get("type", ops.THRESH_BINARY)),
    "gaussiankernel": lambda img, p: ops.gaussian_blur(
        img, p["appertureSize"], p["sigma"]),
    "flip": lambda img, p: ops.flip(img, p.get("horizontal", True)),
}


@register_stage
class ImageTransformer(HasInputCol, HasOutputCol, Transformer):
    stages = ListParam("stages", "ordered list of stage descriptor dicts", [])

    def __init__(self, uid=None, **kwargs):
        kwargs.setdefault("inputCol", "image")
        kwargs.setdefault("outputCol", "image")
        super().__init__(uid, **kwargs)

    # -- fluent setters (reference ImageTransformer setters) ----------------
    def _add(self, stage: Dict[str, Any]) -> "ImageTransformer":
        self.set("stages", list(self.stages) + [stage])
        return self

    def resize(self, height: int, width: int):
        return self._add({"op": "resize", "height": height, "width": width})

    def crop(self, x: int, y: int, height: int, width: int):
        return self._add({"op": "crop", "x": x, "y": y,
                          "height": height, "width": width})

    def center_crop(self, height: int, width: int):
        return self._add({"op": "centercrop", "height": height, "width": width})

    def color_format(self, fmt: str):
        return self._add({"op": "colorformat", "format": fmt})

    def blur(self, height: int, width: int):
        return self._add({"op": "blur", "height": height, "width": width})

    def threshold(self, threshold: float, max_val: float,
                  ttype: str = ops.THRESH_BINARY):
        return self._add({"op": "threshold", "threshold": threshold,
                          "maxVal": max_val, "type": ttype})

    def gaussian_kernel(self, aperture_size: int, sigma: float):
        return self._add({"op": "gaussiankernel",
                          "appertureSize": aperture_size, "sigma": sigma})

    def flip(self, horizontal: bool = True):
        return self._add({"op": "flip", "horizontal": horizontal})

    # -- transform ----------------------------------------------------------
    def transform(self, frame: Frame) -> Frame:
        in_col = frame.schema[self.inputCol]
        stages = list(self.stages)
        for s in stages:
            if s.get("op") not in STAGE_REGISTRY:
                raise SchemaError(f"unknown image stage {s.get('op')!r}")

        def run(p):
            arr = p[self.inputCol]
            paths: List[Optional[str]] = []
            datas: List[np.ndarray] = []
            for i, v in enumerate(arr):
                if in_col.dtype == DType.BINARY:
                    data = decode_image(v)
                    if data is None:
                        raise SchemaError(
                            f"undecodable bytes at row {i}; use read_images "
                            "to drop undecodable files instead")
                    paths.append(None)
                    datas.append(data)
                elif in_col.dtype == DType.IMAGE:
                    paths.append(v.path)
                    datas.append(v.data)
                else:
                    raise SchemaError(
                        f"column {self.inputCol!r} is {in_col.dtype.value}, "
                        "need image or binary")
            # Columnar execution: each stage sweeps the whole partition, so
            # resize batches every same-shape group through one vectorized
            # call instead of a per-image Python loop.
            for s in stages:
                if s["op"] == "resize":
                    datas = ops.resize_many(datas, s["height"], s["width"])
                else:
                    datas = [STAGE_REGISTRY[s["op"]](d, s) for d in datas]
            out = np.empty(len(arr), dtype=np.object_)
            for i, (pth, data) in enumerate(zip(paths, datas)):
                out[i] = ImageValue(path=pth, data=data)
            return out

        return frame.with_column(
            ColumnSchema(self.outputCol, DType.IMAGE), run)


@register_stage
class UnrollImage(HasInputCol, HasOutputCol, Transformer):
    """image -> flat vector (HWC order), requires uniform sizes.

    ``outputDtype='float32'`` (default) matches the reference's
    image->DenseVector contract (``UnrollImage.scala:18-42``);
    ``'uint8'`` keeps the raw bytes — 4x less host->device traffic when the
    consumer (TorchModel) casts on device, the fused-preprocess fast path.
    """

    outputDtype = StringParam("outputDtype", "unrolled element type",
                              "float32", domain=("float32", "uint8"))

    def __init__(self, uid=None, **kwargs):
        kwargs.setdefault("inputCol", "image")
        kwargs.setdefault("outputCol", "features")
        super().__init__(uid, **kwargs)

    def transform(self, frame: Frame) -> Frame:
        # Determine the uniform image shape globally first so empty
        # partitions can still emit correctly-dimensioned (0, N) blocks.
        shapes = {v.data.shape for p in frame.partitions
                  for v in p[self.inputCol]}
        if len(shapes) > 1:
            raise SchemaError(
                f"unroll requires uniform image sizes, got {shapes}; "
                "resize first")
        dim = int(np.prod(next(iter(shapes)))) if shapes else 0
        dtype = np.uint8 if self.outputDtype == "uint8" else np.float32
        if dtype == np.uint8:
            bad = {v.data.dtype for p in frame.partitions
                   for v in p[self.inputCol]} - {np.dtype(np.uint8)}
            if bad:
                raise SchemaError(
                    f"outputDtype='uint8' would truncate {sorted(map(str, bad))} "
                    "image data; use the default float32")

        def unroll(p):
            arr = p[self.inputCol]
            if len(arr) == 0:
                return np.zeros((0, dim), dtype)
            return np.stack([v.data.reshape(-1).astype(dtype)
                             for v in arr])

        return frame.with_column(
            ColumnSchema(self.outputCol, DType.VECTOR, dim or None), unroll)
