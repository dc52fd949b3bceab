"""Param DSL: typed, validated, JSON-serializable stage parameters.

The PyTorch port's own copy of ``mmlspark_tpu/core/params.py``.

Re-expression of the reference's MML param system
(``core/contracts/src/main/scala/Params.scala:12-134``): factory methods
producing params with defaults and string domains, plus shared-column mixins
(``HasInputCol``/``HasOutputCol``/``HasLabelCol``/``HasFeaturesCol``).

Differences from the reference, by design:
- No JVM reflection; params are plain descriptors on Python classes.
- JSON is the single serialization dialect (the reference splits between
  Spark ML param JSON and java serialization).
"""
from __future__ import annotations

import copy
import uuid
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np

_UNSET = object()


class ParamException(ValueError):
    """Raised when a param value fails validation.

    Reference: ``core/contracts/src/main/scala/Exceptions.scala:27-36``.
    """


class Param:
    """A single named, documented, optionally-validated parameter.

    Mirrors the reference's ``Wrappable.BooleanParam/IntParam/...`` factories
    (``Params.scala:12-110``) as one descriptor with a ``dtype`` and optional
    ``domain`` (string-domain validation) or ``validator`` predicate.
    """

    def __init__(
        self,
        name: str,
        doc: str,
        default: Any = _UNSET,
        dtype: Optional[type] = None,
        domain: Optional[Sequence[Any]] = None,
        validator: Optional[Callable[[Any], bool]] = None,
    ):
        self.name = name
        self.doc = doc
        self.default = default
        self.dtype = dtype
        self.domain = tuple(domain) if domain is not None else None
        self.validator = validator

    @property
    def has_default(self) -> bool:
        return self.default is not _UNSET

    def validate(self, value: Any) -> Any:
        if self.dtype is not None and value is not None:
            # numpy scalars arrive constantly in a numpy-centric framework
            if isinstance(value, np.bool_):
                value = bool(value)
            elif isinstance(value, np.integer):
                value = int(value)
            elif isinstance(value, np.floating):
                value = float(value)
            if self.dtype is float and isinstance(value, int) and not isinstance(value, bool):
                value = float(value)
            if not isinstance(value, self.dtype):
                raise ParamException(
                    f"param {self.name!r}: expected {self.dtype.__name__}, "
                    f"got {type(value).__name__} ({value!r})"
                )
        if self.domain is not None and value not in self.domain:
            raise ParamException(
                f"param {self.name!r}: {value!r} not in domain {list(self.domain)}"
            )
        if self.validator is not None and not self.validator(value):
            raise ParamException(f"param {self.name!r}: {value!r} failed validation")
        return value

    def __repr__(self) -> str:  # pragma: no cover
        return f"Param({self.name!r})"

    # Descriptor protocol: `stage.paramName` reads the current value.
    def __set_name__(self, owner, attr_name):
        self._attr = attr_name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj.get(self)

    def __set__(self, obj, value):
        obj.set(self, value)


def BooleanParam(name: str, doc: str, default: Any = _UNSET) -> Param:
    return Param(name, doc, default, dtype=bool)


def IntParam(name: str, doc: str, default: Any = _UNSET, validator=None) -> Param:
    return Param(name, doc, default, dtype=int, validator=validator)


def FloatParam(name: str, doc: str, default: Any = _UNSET, validator=None) -> Param:
    return Param(name, doc, default, dtype=float, validator=validator)


def StringParam(
    name: str, doc: str, default: Any = _UNSET, domain: Optional[Sequence[str]] = None
) -> Param:
    return Param(name, doc, default, dtype=str, domain=domain)


def ListParam(name: str, doc: str, default: Any = _UNSET) -> Param:
    return Param(name, doc, default, dtype=list)


def DictParam(name: str, doc: str, default: Any = _UNSET) -> Param:
    return Param(name, doc, default, dtype=dict)


def AnyParam(name: str, doc: str, default: Any = _UNSET) -> Param:
    """Param holding arbitrary objects (estimators, transformers, arrays).

    Counterpart of the reference's ``EstimatorParam``/``TransformerParam``/
    ``TransformerArrayParam`` (``core/spark/src/main/scala/TransformParam.scala``).
    Serialized via the stage-serialization layer, not plain JSON.
    """
    return Param(name, doc, default)


class Params:
    """Base for anything carrying params; tracks explicitly-set vs default values.

    The `uid` follows the reference convention (`ClassName_xxxxxxxx`).
    """

    def __init__(self, uid: Optional[str] = None, **kwargs):
        self.uid = uid or f"{type(self).__name__}_{uuid.uuid4().hex[:12]}"
        self._paramMap: Dict[str, Any] = {}
        self.set_params(**kwargs)

    # -- param discovery ---------------------------------------------------
    @classmethod
    def params(cls) -> List[Param]:
        out, seen = [], set()
        for klass in cls.__mro__:
            for v in vars(klass).values():
                if isinstance(v, Param) and v.name not in seen:
                    seen.add(v.name)
                    out.append(v)
        return out

    @classmethod
    def get_param(cls, name: str) -> Param:
        for p in cls.params():
            if p.name == name:
                return p
        raise ParamException(f"{cls.__name__} has no param {name!r}")

    # -- get/set -----------------------------------------------------------
    @staticmethod
    def _unchanged(cur, new) -> bool:
        if cur is new:
            return True
        try:
            return bool(cur == new)
        except Exception:  # ambiguous comparisons (arrays) -> treat as changed
            return False

    def set(self, param, value) -> "Params":
        if isinstance(param, str):
            param = self.get_param(param)
        value = param.validate(value)
        # built closures may capture param values — but a no-op set must
        # not throw away a built model on the device (e.g. re-stamping the
        # same inputCol on a cached scoring model every transform() call)
        if not (param.name in self._paramMap
                and self._unchanged(self._paramMap[param.name], value)):
            self._build_cache = None
        self._paramMap[param.name] = value
        return self

    def set_params(self, **kwargs) -> "Params":
        for k, v in kwargs.items():
            self.set(k, v)
        return self

    def get(self, param, default: Any = _UNSET) -> Any:
        if isinstance(param, str):
            param = self.get_param(param)
        if param.name in self._paramMap:
            return self._paramMap[param.name]
        if param.has_default:
            return copy.copy(param.default)
        if default is not _UNSET:
            return default
        raise ParamException(
            f"{type(self).__name__}: param {param.name!r} is not set and has no default"
        )

    def is_set(self, param) -> bool:
        if isinstance(param, str):
            param = self.get_param(param)
        return param.name in self._paramMap

    def is_defined(self, param) -> bool:
        if isinstance(param, str):
            param = self.get_param(param)
        return param.name in self._paramMap or param.has_default

    def copy(self) -> "Params":
        other = copy.copy(self)
        other._paramMap = dict(self._paramMap)
        if hasattr(self, "_state"):
            other._state = copy.deepcopy(self._state)
        other._build_cache = None  # never share built closures with the copy
        return other

    def explain_params(self) -> str:
        lines = []
        for p in sorted(self.params(), key=lambda p: p.name):
            cur = self._paramMap.get(p.name, p.default if p.has_default else "<unset>")
            lines.append(f"{p.name}: {p.doc} (current: {cur!r})")
        return "\n".join(lines)

    def explicit_param_values(self) -> Dict[str, Any]:
        return dict(self._paramMap)

    def __repr__(self) -> str:
        kv = ", ".join(f"{k}={v!r}" for k, v in sorted(self._paramMap.items()))
        return f"{type(self).__name__}(uid={self.uid!r}, {kv})"


# -- shared-column mixins (reference Params.scala:112-134) -------------------
class HasInputCol(Params):
    inputCol = StringParam("inputCol", "name of the input column", "input")


class HasOutputCol(Params):
    outputCol = StringParam("outputCol", "name of the output column", "output")


class HasInputCols(Params):
    inputCols = ListParam("inputCols", "names of the input columns")


class HasLabelCol(Params):
    labelCol = StringParam("labelCol", "name of the label column", "label")


class HasFeaturesCol(Params):
    featuresCol = StringParam("featuresCol", "name of the features column", "features")
