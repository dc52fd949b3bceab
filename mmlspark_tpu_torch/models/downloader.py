"""ModelDownloader: pretrained-model repository with manifest + sha256.

The port's copy of ``mmlspark_tpu/models/downloader.py``, itself a
re-expression of ``downloader/src/main/scala/ModelDownloader.scala:24-260``
and ``Schema.scala:31-92``:

- ``ModelSchema`` keeps the reference's fields (name/dataset/modelType/uri/
  hash/size/inputNode/numLayers/layerNames) so repository listings are
  drop-in compatible;
- ``LocalRepo`` = the reference's HDFSRepo idea: a cache directory holding
  model blobs + ``.meta`` JSON sidecars;
- ``HttpRepo`` = DefaultModelRepo: a base URL serving a MANIFEST file of
  schema JSON lines (fetch via urllib; sha256-verified on arrival);
- model payloads are ``.npz`` param archives: the JAX package's flax
  parameter paths joined by ``␟``, so a repository written by either
  package loads in the other. :meth:`LocalRepo.save_model` takes a flax
  tree or the port's state dict (converted by
  :func:`~mmlspark_tpu_torch.models.convert.to_jax_params`), and
  :meth:`ModelDownloader.to_torch_model` hydrates a ``TorchModel``.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import urllib.error
import urllib.request
from dataclasses import asdict, dataclass, field
from email.utils import parsedate_to_datetime
from typing import Any, Dict, Iterable, List, Optional, Union

import numpy as np

from mmlspark_tpu_torch.observability import events as obsevents
from mmlspark_tpu_torch.observability import metrics as obsmetrics
from mmlspark_tpu_torch.reliability.faults import fault_site
from mmlspark_tpu_torch.reliability.retry import RetryPolicy


@dataclass
class ModelSchema:
    name: str
    architecture: str = ""           # zoo key (the reference's modelType)
    dataset: str = ""
    uri: str = ""
    hash: str = ""                   # sha256 hex of the payload
    size: int = 0
    inputNode: str = ""
    numLayers: int = 0
    layerNames: List[str] = field(default_factory=list)
    architectureArgs: Dict[str, Any] = field(default_factory=dict)
    # input preprocessing the net was trained with (per-channel or scalar;
    # empty = raw). The reference's CNTK graphs embedded their own input
    # normalization; here it rides the schema so a downloaded model scores
    # the distribution it was trained on.
    inputMean: List[float] = field(default_factory=list)
    inputStd: List[float] = field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps(asdict(self), sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "ModelSchema":
        return ModelSchema(**json.loads(s))


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


class Repository:
    """Abstract model repository (reference Repository[S <: Schema])."""

    def list_schemas(self) -> Iterable[ModelSchema]:
        raise NotImplementedError

    def get_model_path(self, schema: ModelSchema) -> str:
        raise NotImplementedError

    def find_by_name(self, name: str) -> ModelSchema:
        for s in self.list_schemas():
            if s.name == name:
                return s
        raise KeyError(f"model {name!r} not found in repository")


class LocalRepo(Repository):
    """Directory cache: <name>.npz payload + <name>.meta sidecar."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def list_schemas(self) -> List[ModelSchema]:
        out = []
        for fn in sorted(os.listdir(self.root)):
            if fn.endswith(".meta"):
                with open(os.path.join(self.root, fn)) as f:
                    out.append(ModelSchema.from_json(f.read()))
        return out

    def get_model_path(self, schema: ModelSchema) -> str:
        path = os.path.join(self.root, f"{schema.name}.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(f"model payload missing: {path}")
        if schema.hash:
            actual = sha256_file(path)
            if actual != schema.hash:
                raise IOError(f"sha256 mismatch for {schema.name}: "
                              f"{actual} != {schema.hash}")
        return path

    def save_model(self, schema: ModelSchema, params: Any) -> ModelSchema:
        """Flatten a param tree into an npz payload + write sidecar.
        ``params`` is the JAX package's flax tree or the port's flat state
        dict (dotted module paths), written as the flax tree of
        ``schema.architecture``."""
        if not any(isinstance(v, dict) for v in params.values()) \
                and any("." in k for k in params):
            from mmlspark_tpu_torch.models.convert import to_jax_params
            from mmlspark_tpu_torch.models.zoo import build_model
            module = build_model(schema.architecture,
                                 **schema.architectureArgs)["module"]
            params = to_jax_params(params, module)
        flat = _flatten_params(params)
        path = os.path.join(self.root, f"{schema.name}.npz")
        np.savez(path, **flat)
        schema.hash = sha256_file(path)
        schema.size = os.path.getsize(path)
        with open(os.path.join(self.root, f"{schema.name}.meta"), "w") as f:
            f.write(schema.to_json())
        return schema

    def write_manifest(self) -> str:
        """Write the ``MANIFEST`` file (one schema JSON per line) that
        HttpRepo clients list — serving this directory over any static
        HTTP server makes it a remote model repository, the publishing
        half of the reference's DefaultModelRepo."""
        path = os.path.join(self.root, "MANIFEST")
        with open(path, "w") as f:
            for s in self.list_schemas():
                f.write(s.to_json() + "\n")
        return path


def _parse_retry_after(value: Optional[str]) -> Optional[float]:
    """``Retry-After`` header -> seconds (delta-seconds or HTTP-date form);
    None when absent or unparseable. Never raises — a malformed header
    must not turn a retryable 503 into a crash."""
    if not value:
        return None
    try:
        return max(0.0, float(value))
    except ValueError:
        pass
    try:
        import datetime
        when = parsedate_to_datetime(value)
        now = datetime.datetime.now(datetime.timezone.utc)
        if when.tzinfo is None:
            when = when.replace(tzinfo=datetime.timezone.utc)
        return max(0.0, (when - now).total_seconds())
    except (TypeError, ValueError):
        return None


class HttpRepo(Repository):
    """Remote repository: <base>/MANIFEST lists schema JSON, one per line.

    Hardened fetch path (reliability subsystem): every ``urlopen`` carries a
    timeout, MANIFEST and model fetches run under a :class:`RetryPolicy`,
    payloads land in a ``.tmp`` file that is sha256-verified (when the
    schema carries a hash) BEFORE ``os.replace`` into the cache — a
    truncated or corrupt transfer is retried, never cached, and a crash
    mid-download leaves no partial file at the cache path. A cached file
    that no longer matches its hash (torn write from a pre-hardening
    client, bitrot) is re-fetched instead of erroring forever.
    """

    def __init__(self, base_url: str, cache: Union[LocalRepo, str],
                 timeout: Optional[float] = None,
                 retry: Optional["RetryPolicy"] = None,
                 breaker: Optional["CircuitBreaker"] = None):
        from urllib.parse import urlparse
        from mmlspark_tpu_torch.reliability.breaker import breaker_for
        from mmlspark_tpu_torch.utils import config
        self.base_url = base_url.rstrip("/")
        self.cache = LocalRepo(cache) if isinstance(cache, str) else cache
        self.timeout = (float(config.get("reliability.http_timeout"))
                        if timeout is None else timeout)
        self.retry = retry if retry is not None else RetryPolicy(
            max_attempts=int(config.get("reliability.max_attempts")),
            base_delay=float(config.get("reliability.base_delay")),
            name="downloader")
        # one breaker per repo HOST (process-wide): when the registry is
        # down, every HttpRepo instance pointed at it fails fast together
        # instead of each burning its own backoff schedule
        host = urlparse(self.base_url).netloc or self.base_url
        self.breaker = breaker if breaker is not None \
            else breaker_for(f"downloader.{host}")

    def _fetch(self, url: str) -> bytes:
        """One guarded fetch: the circuit breaker wraps the socket work,
        and a 429/503 response's ``Retry-After`` header is attached to the
        re-raised error (``retry_after`` seconds) so the retry layer backs
        off for as long as the server asked, not just its own schedule."""
        fault_site("downloader.fetch")

        def _read() -> bytes:
            try:
                with urllib.request.urlopen(url, timeout=self.timeout) as r:
                    return r.read()
            except urllib.error.HTTPError as e:
                if e.code in (429, 503):
                    e.retry_after = _parse_retry_after(
                        e.headers.get("Retry-After"))
                raise

        data = self.breaker.call(_read)
        return fault_site("downloader.payload", payload=data)

    def list_schemas(self) -> List[ModelSchema]:
        fault_site("downloader.manifest")
        data = self.retry.call(self._fetch, f"{self.base_url}/MANIFEST")
        lines = data.decode("utf-8").splitlines()
        return [ModelSchema.from_json(l) for l in lines if l.strip()]

    def _download(self, url: str, schema: ModelSchema, path: str) -> None:
        """One fetch attempt: tmp file -> sha256 verify -> atomic replace.
        A hash mismatch raises IOError (retryable: it means a truncated or
        corrupted transfer) and leaves the cache untouched."""
        data = self._fetch(url)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            if schema.hash:
                actual = sha256_file(tmp)
                if actual != schema.hash:
                    raise IOError(
                        f"sha256 mismatch downloading {schema.name} "
                        f"({len(data)} bytes): {actual} != {schema.hash}")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    def get_model_path(self, schema: ModelSchema) -> str:
        path = os.path.join(self.cache.root, f"{schema.name}.npz")
        cached_ok = os.path.exists(path) and (
            not schema.hash or sha256_file(path) == schema.hash)
        # cache telemetry: counters are cold-path (a download dwarfs an int
        # add), so they are unconditional; events stay behind the path gate
        if cached_ok:
            obsmetrics.counter("downloader.cache_hits").inc()
        else:
            obsmetrics.counter("downloader.cache_misses").inc()
            url = schema.uri or f"{self.base_url}/{schema.name}.npz"
            self.retry.call(self._download, url, schema, path)
            with open(os.path.join(self.cache.root,
                                   f"{schema.name}.meta"), "w") as f:
                f.write(schema.to_json())
            obsmetrics.counter("downloader.downloads").inc()
            if obsevents.events_enabled():
                obsevents.emit("event", "downloader.download",
                               model=schema.name, url=url,
                               bytes=os.path.getsize(path))
        return self.cache.get_model_path(schema)


class ModelDownloader:
    """Facade (reference ModelDownloader): resolve name -> local npz path,
    and hydrate a TorchModel from it."""

    def __init__(self, repo: Repository):
        self.repo = repo

    def download_by_name(self, name: str) -> str:
        return self.repo.get_model_path(self.repo.find_by_name(name))

    def load_params(self, name: str) -> Any:
        """The payload as the JAX package's flax tree (numpy leaves), which
        ``TorchModel.set_model`` converts."""
        path = self.download_by_name(name)
        with np.load(path, allow_pickle=False) as z:
            return _unflatten_params({k: z[k] for k in z.files})

    def to_torch_model(self, name: str, **torch_model_kwargs):
        """The reference's ``to_jax_model``: a ``TorchModel`` of the
        schema's architecture, params and input normalization."""
        from mmlspark_tpu_torch.models.torch_model import TorchModel
        schema = self.repo.find_by_name(name)
        params = self.load_params(name)
        m = TorchModel(**torch_model_kwargs)
        m.set_model(schema.architecture, params=params,
                    input_mean=schema.inputMean or None,
                    input_std=schema.inputStd or None,
                    **schema.architectureArgs)
        return m


def _flatten_params(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten_params(v, f"{prefix}{k}␟"))
    else:
        out[prefix.rstrip("␟")] = np.asarray(tree)
    return out


def _unflatten_params(flat: Dict[str, np.ndarray]):
    tree: Dict[str, Any] = {}
    for key, arr in flat.items():
        parts = key.split("␟")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree
