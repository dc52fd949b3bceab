"""Stage save/load: metadata JSON + numpy blob archives + nested stages.

The PyTorch port's own copy of ``mmlspark_tpu/core/serialization.py``,
with its own stage registry: port stages register and resolve here, never
in the JAX package's registry. Mesh-valued params (``meshSpec``: a
``MeshSpec`` or a ``DeviceMesh``) persist as the reference's axis-size
dicts, which ``parallel.mesh.resolve_mesh`` takes back.

Replaces the reference's three serialization mechanisms with one:
- Spark ML param JSON (``PipelineUtilities.saveMetadata``,
  ``utils/src/main/scala/PipelineUtilities.scala:19-47``)
- parquet data parts
- Java-serialized objects (``ObjectUtilities.scala:13-71``)

Layout of a saved stage directory:
    metadata.json   {class, uid, version, params: {...}, state: <encoded pytree>}
    arrays.npz      ndarray leaves referenced from metadata.json by key
    params/<name>/  nested stage(s) for params holding stages

A class registry (populated by the ``@register_stage`` decorator) maps the
qualified class name back to the class at load time; it doubles as the stage
inventory that tooling can introspect (the
equivalent of ``JarLoadingUtils`` reflection, ``utils/src/main/scala/JarLoadingUtils.scala:18-139``).
"""
from __future__ import annotations

import importlib
import json
import os
from typing import Any, Dict, List, Optional, Tuple, Type

import numpy as np

FORMAT_VERSION = 1

_STAGE_REGISTRY: Dict[str, Type] = {}


def register_stage(cls=None):
    """Class decorator adding the stage to the global registry."""
    def wrap(c):
        _STAGE_REGISTRY[f"{c.__module__}.{c.__name__}"] = c
        _STAGE_REGISTRY[c.__name__] = c
        return c
    return wrap(cls) if cls is not None else wrap


def registered_stages() -> Dict[str, Type]:
    """Qualified-name -> class map (short-name aliases filtered out)."""
    return {k: v for k, v in _STAGE_REGISTRY.items() if "." in k}


def _resolve_class(qualname: str) -> Type:
    if qualname in _STAGE_REGISTRY:
        return _STAGE_REGISTRY[qualname]
    module, _, name = qualname.rpartition(".")
    cls = getattr(importlib.import_module(module), name)
    return cls


# -- pytree <-> (json, arrays) codec ----------------------------------------
def _encode(obj: Any, arrays: Dict[str, np.ndarray], path: str) -> Any:
    if isinstance(obj, np.ndarray):
        if obj.dtype == np.object_:
            raise TypeError(
                f"object ndarray at state path {path!r} cannot be serialized "
                "safely; convert to a list or a typed array first")
        arrays[path] = obj
        return {"__nd__": path}
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    if isinstance(obj, bytes):
        arrays[path] = np.frombuffer(obj, dtype=np.uint8)
        return {"__bytes__": path}
    if isinstance(obj, dict):
        if all(isinstance(k, str) for k in obj):
            return {"__dict__": {k: _encode(v, arrays, f"{path}/{k}")
                                 for k, v in obj.items()}}
        # non-string keys (e.g. index->label maps): store as key/value pairs
        return {"__items__": [
            [_encode(k, arrays, f"{path}/k{i}"), _encode(v, arrays, f"{path}/v{i}")]
            for i, (k, v) in enumerate(obj.items())]}
    if isinstance(obj, tuple):
        return {"__tuple__": [_encode(v, arrays, f"{path}/{i}")
                              for i, v in enumerate(obj)]}
    if isinstance(obj, list):
        return [_encode(v, arrays, f"{path}/{i}") for i, v in enumerate(obj)]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    mesh_dict = _mesh_to_dict(obj)
    if mesh_dict is not None:
        return _encode(mesh_dict, arrays, path)
    raise TypeError(f"cannot serialize {type(obj).__name__} at state path {path!r}")


def _mesh_to_dict(obj: Any):
    """Mesh-shaped param values (DeepClassifier's ``meshSpec``) persist as
    axis-size dicts: a live ``DeviceMesh`` is bound to its process group
    (its ranks mean nothing in another run), and ``resolve_mesh`` accepts
    the dict back, so save/load round-trips the SHAPE, the portable part.
    None for anything else."""
    from dataclasses import asdict
    from mmlspark_tpu_torch.parallel.mesh import AXES, MeshSpec, mesh_shape
    if isinstance(obj, MeshSpec):
        return asdict(obj)
    from torch.distributed.device_mesh import DeviceMesh
    if isinstance(obj, DeviceMesh):
        names = obj.mesh_dim_names or ()
        bad = sorted(set(names) - set(AXES)) if names else ["<unnamed>"]
        if bad:
            raise TypeError(
                f"cannot persist a DeviceMesh with non-standard axes {bad}: "
                "resolve_mesh could not rebuild it at load; use the "
                f"standard axis names {AXES}")
        return mesh_shape(obj)
    return None


def _decode(obj: Any, arrays: Dict[str, np.ndarray]) -> Any:
    if isinstance(obj, dict):
        if "__nd__" in obj:
            return arrays[obj["__nd__"]]
        if "__bytes__" in obj:
            return arrays[obj["__bytes__"]].tobytes()
        if "__dict__" in obj:
            return {k: _decode(v, arrays) for k, v in obj["__dict__"].items()}
        if "__items__" in obj:
            return {_decode(k, arrays): _decode(v, arrays)
                    for k, v in obj["__items__"]}
        if "__tuple__" in obj:
            return tuple(_decode(v, arrays) for v in obj["__tuple__"])
    if isinstance(obj, list):
        return [_decode(v, arrays) for v in obj]
    return obj


# -- param value encoding (may contain nested stages) ------------------------
def _is_stage(v: Any) -> bool:
    from mmlspark_tpu_torch.core.pipeline import PipelineStage
    return isinstance(v, PipelineStage)


def _encode_param(name: str, value: Any, path: str,
                  arrays: Dict[str, np.ndarray]) -> Any:
    if _is_stage(value):
        sub = os.path.join(path, "params", name)
        save_stage(value, sub)
        return {"__stage__": f"params/{name}"}
    if isinstance(value, list) and any(_is_stage(v) for v in value):
        rels = []
        for i, v in enumerate(value):
            sub = os.path.join(path, "params", f"{name}_{i}")
            save_stage(v, sub)
            rels.append(f"params/{name}_{i}")
        return {"__stages__": rels}
    return _encode(value, arrays, f"__param__/{name}")


def _decode_param(value: Any, path: str, arrays: Dict[str, np.ndarray]) -> Any:
    if isinstance(value, dict) and "__stage__" in value:
        return load_stage(os.path.join(path, value["__stage__"]))
    if isinstance(value, dict) and "__stages__" in value:
        return [load_stage(os.path.join(path, rel)) for rel in value["__stages__"]]
    return _decode(value, arrays)


# -- public API --------------------------------------------------------------
def save_stage(stage, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    params = {name: _encode_param(name, value, path, arrays)
              for name, value in stage.explicit_param_values().items()}
    state = _encode(stage._get_state(), arrays, "__state__")
    meta = {
        "class": f"{type(stage).__module__}.{type(stage).__name__}",
        "uid": stage.uid,
        "version": FORMAT_VERSION,
        "params": params,
        "state": state,
    }
    if arrays:
        np.savez(os.path.join(path, "arrays.npz"),
                 **{k.replace("/", "╱"): v for k, v in arrays.items()})
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=1, default=_json_fallback)


def load_stage(path: str):
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    arrays: Dict[str, np.ndarray] = {}
    npz_path = os.path.join(path, "arrays.npz")
    if os.path.exists(npz_path):
        with np.load(npz_path, allow_pickle=False) as z:
            arrays = {k.replace("╱", "/"): z[k] for k in z.files}
    cls = _resolve_class(meta["class"])
    stage = cls.__new__(cls)
    from mmlspark_tpu_torch.core.params import Params
    Params.__init__(stage, uid=meta["uid"])
    for name, enc in meta["params"].items():
        stage.set(name, _decode_param(enc, path, arrays))
    stage._set_state(_decode(meta["state"], arrays))
    if hasattr(stage, "_post_load"):
        stage._post_load()
    return stage


def stage_fingerprint(stage) -> str:
    """Content hash of a stage: class + explicit params + state, nested
    stages included, uids EXCLUDED — two stages fit identically (same
    config, same data) fingerprint the same even though their uids differ.
    FindBestModel uses this to share one featurize pass across candidates
    whose featurization is semantically identical."""
    import hashlib
    h = hashlib.sha256()

    def feed(o):
        if _is_stage(o):
            h.update(b"\x01")
            h.update(f"{type(o).__module__}.{type(o).__name__}".encode())
            for k, v in sorted(o.explicit_param_values().items()):
                h.update(k.encode())
                feed(v)
            h.update(b"\x02")
            feed(o._get_state())
        elif isinstance(o, dict):
            h.update(b"\x03")
            for k in sorted(o, key=str):
                if str(k) in ("uid", "model_uid"):
                    continue  # identity, not content
                h.update(str(k).encode())
                feed(o[k])
        elif isinstance(o, (list, tuple)):
            h.update(b"\x04")
            for v in o:
                feed(v)
        elif isinstance(o, np.ndarray):
            h.update(b"\x05")
            h.update(str(o.dtype).encode())
            h.update(str(o.shape).encode())
            h.update(o.tobytes() if o.dtype != np.object_
                     else repr(o.tolist()).encode())  # lint: allow-sync (numpy object array)
        else:
            h.update(b"\x06")
            h.update(repr(o).encode())

    feed(stage)
    return h.hexdigest()


def _json_fallback(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, (np.bool_,)):
        return bool(o)
    raise TypeError(f"not JSON serializable: {type(o).__name__}")
