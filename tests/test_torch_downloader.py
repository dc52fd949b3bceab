"""The port's model downloader against the JAX package's.

- A ``LocalRepo`` written by the JAX package loads in the port and scores
  within 1e-4 of the JAX package (fp32), and a repository the port writes
  from its own state dict loads in the JAX package the same way: the npz
  payload is the flax tree in both.
- ``to_jax_params(from_jax_params(t), module) == t``, leaf for leaf, for
  every zoo architecture.
- sha256 mismatches, a missing payload, ``HttpRepo``'s retries of
  transient errors and torn payloads, and a 503's ``Retry-After`` behave as
  in the reference's tests. Every server is a localhost ``http.server``
  thread.
"""
import functools
import http.server
import os
import threading
import time
import urllib.error

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.frame import Frame as JFrame
from mmlspark_tpu.models import downloader as jdl
from mmlspark_tpu.models.zoo import build_model as jbuild
from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.core.schema import ColumnSchema, DType, ImageValue
from mmlspark_tpu_torch.image.featurizer import ImageFeaturizer
from mmlspark_tpu_torch.models import downloader as dl
from mmlspark_tpu_torch.models.convert import from_jax_params, to_jax_params
from mmlspark_tpu_torch.models.zoo import build_model, shared_models
from mmlspark_tpu_torch.reliability.breaker import reset_breakers
from mmlspark_tpu_torch.reliability.faults import FaultPlan, FaultSpec
from mmlspark_tpu_torch.reliability.retry import RetryPolicy
from mmlspark_tpu_torch.utils import config as tconfig

ARCH = dict(num_classes=10, dtype="float32")
_NOSLEEP = dict(sleep=lambda s: None)


@pytest.fixture(autouse=True)
def _cpu_device():
    tconfig.set("runtime.device", "cpu")
    reset_breakers()
    yield
    tconfig.unset("runtime.device")
    reset_breakers()


@pytest.fixture(scope="module")
def jparams():
    module = jbuild("resnet20_cifar", **ARCH)["module"]
    params = jax.jit(module.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 32, 32, 3)))
    return jax.tree_util.tree_map(np.array, params)


def _x(n=3, seed=5):
    return np.random.default_rng(seed).normal(
        size=(n, 32 * 32 * 3)).astype(np.float32)


def _schema(mod, name="r20"):
    return mod.ModelSchema(name=name, architecture="resnet20_cifar",
                           architectureArgs=dict(ARCH),
                           layerNames=["pool", "head"],
                           inputMean=[0.5], inputStd=[2.0])


def test_jax_written_repo_loads_and_scores_in_the_port(tmp_path, jparams):
    jrepo = jdl.LocalRepo(str(tmp_path))
    jrepo.save_model(_schema(jdl), jparams)
    want = jdl.ModelDownloader(jrepo).to_jax_model(
        "r20", inputCol="x", outputCol="o").transform(
            JFrame.from_dict({"x": _x()})).column("o")
    repo = dl.LocalRepo(str(tmp_path))
    assert [s.name for s in repo.list_schemas()] == ["r20"]
    tm = dl.ModelDownloader(repo).to_torch_model("r20", inputCol="x",
                                                 outputCol="o")
    got = tm.transform(Frame.from_dict({"x": _x()})).column("o")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=1e-4, rtol=0)
    assert tm._state["input_mu"].tolist() == [0.5]


def test_port_written_repo_loads_and_scores_in_the_jax_package(tmp_path,
                                                               jparams):
    state = from_jax_params(jparams)
    repo = dl.LocalRepo(str(tmp_path))
    schema = repo.save_model(_schema(dl),
                             {k: torch.from_numpy(v) for k, v in
                              state.items()})
    assert schema.hash == dl.sha256_file(str(tmp_path / "r20.npz"))
    jrepo = jdl.LocalRepo(str(tmp_path))
    loaded = jdl.ModelDownloader(jrepo).load_params("r20")
    flat_want = jdl._flatten_params(jparams)
    flat_got = jdl._flatten_params(loaded)
    assert set(flat_got) == set(flat_want)
    for k in flat_want:
        np.testing.assert_array_equal(flat_got[k], flat_want[k])
    want = jdl.ModelDownloader(jrepo).to_jax_model(
        "r20", inputCol="x", outputCol="o").transform(
            JFrame.from_dict({"x": _x()})).column("o")
    got = dl.ModelDownloader(repo).to_torch_model(
        "r20", inputCol="x", outputCol="o").transform(
            Frame.from_dict({"x": _x()})).column("o")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=1e-4, rtol=0)


def test_featurizer_from_downloader_equals_set_model(tmp_path, jparams):
    repo = dl.LocalRepo(str(tmp_path))
    repo.save_model(_schema(dl), jparams)
    images = np.random.default_rng(2).integers(0, 256, (4, 32, 32, 3),
                                               dtype=np.uint8)
    vals = np.empty(len(images), dtype=object)
    for i, im in enumerate(images):
        vals[i] = ImageValue(path=f"mem://{i}", data=im)
    frame = Frame.from_dict({"row": np.arange(4)}).with_column_values(
        ColumnSchema("img", DType.IMAGE), vals)
    a = ImageFeaturizer(inputCol="img", outputCol="f", cutOutputLayers=1)
    a.set_model_from_downloader(dl.ModelDownloader(repo), "r20")
    b = ImageFeaturizer(inputCol="img", outputCol="f", cutOutputLayers=1)
    b.set_model("resnet20_cifar", params=jparams, input_mean=[0.5],
                input_std=[2.0], **ARCH)
    np.testing.assert_array_equal(np.asarray(a.transform(frame).column("f")),
                                  np.asarray(b.transform(frame).column("f")))


SMALL = {
    "transformer_lm": dict(vocab=128, dim=32, depth=1, heads=4, max_len=16),
    "transformer_lm_moe": dict(vocab=128, dim=32, depth=2, heads=4,
                               max_len=16, num_experts=4),
    "vit_b16": dict(image_size=32), "textcnn": dict(vocab_size=50),
}


@pytest.mark.parametrize("name", shared_models())
def test_to_jax_params_inverts_from_jax_params(name):
    kw = SMALL.get(name, {})
    spec = jbuild(name, **kw)
    shape = (1,) + tuple(spec["input_shape"])
    if name == "resnet50":
        shape = (1, 64, 64, 3)      # the params do not depend on the size
    dtype = jnp.int32 if spec.get("input_dtype") == "int32" else jnp.float32
    tree = jax.tree_util.tree_map(np.asarray, jax.jit(spec["module"].init)(
        jax.random.PRNGKey(0), jnp.zeros(shape, dtype)))
    module = build_model(name, **kw)["module"]
    state = from_jax_params(tree)
    module.load_state_dict({k: torch.from_numpy(v) for k, v in
                            state.items()}, strict=True)
    back = to_jax_params(state, module)
    want, got = jdl._flatten_params(tree), jdl._flatten_params(back)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k])


def test_attention_leaves_need_the_module():
    state = {"block0.attn.query.weight": np.zeros((8, 8), np.float32)}
    with pytest.raises(ValueError, match="head count"):
        to_jax_params(state)


def test_local_repo_sha256_mismatch_and_missing_payload(tmp_path):
    repo = dl.LocalRepo(str(tmp_path))
    params = {"w": np.arange(16, dtype=np.float32).reshape(4, 4)}
    schema = repo.save_model(dl.ModelSchema(name="m"), params)
    assert repo.get_model_path(schema).endswith("m.npz")
    with open(tmp_path / "m.npz", "ab") as f:
        f.write(b"x")
    with pytest.raises(IOError, match="sha256 mismatch"):
        repo.get_model_path(schema)
    os.remove(tmp_path / "m.npz")
    with pytest.raises(FileNotFoundError, match="payload missing"):
        repo.get_model_path(schema)
    with pytest.raises(KeyError, match="not found"):
        repo.find_by_name("nope")


# -- HttpRepo over a localhost server -----------------------------------------

class _Handler(http.server.SimpleHTTPRequestHandler):
    """Static files, but the first ``fail_first`` GETs answer 503 with a
    ``Retry-After`` of ``retry_after``."""
    fail_first = 0
    retry_after = "0.25"
    seen = []

    def do_GET(self):
        type(self).seen.append(self.path)
        if type(self).fail_first > 0:
            type(self).fail_first -= 1
            self.send_response(503)
            self.send_header("Retry-After", type(self).retry_after)
            self.end_headers()
            return
        super().do_GET()

    def log_message(self, *args):
        pass


@pytest.fixture
def model_server(tmp_path):
    serve_dir = tmp_path / "served"
    serve_dir.mkdir()
    publish = dl.LocalRepo(str(serve_dir))
    params = {"w": np.arange(64, dtype=np.float32).reshape(8, 8),
              "b": np.ones((8,), np.float32)}
    schema = publish.save_model(
        dl.ModelSchema(name="tiny", architecture="mlp_tabular"),
        {"params": params})
    publish.write_manifest()
    handler = type("H", (_Handler,), {"fail_first": 0, "seen": []})
    server = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(handler,
                                            directory=str(serve_dir)))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    cache_dir = tmp_path / "cache"
    cache_dir.mkdir()
    try:
        yield (f"http://127.0.0.1:{server.server_address[1]}", schema,
               dl.LocalRepo(str(cache_dir)), handler)
    finally:
        server.shutdown()
        server.server_close()


def _repo(base, cache, **retry_kw):
    retry_kw.setdefault("max_attempts", 3)
    retry_kw = {**_NOSLEEP, **retry_kw}
    return dl.HttpRepo(base, cache, timeout=5.0, retry=RetryPolicy(**retry_kw))


def test_transient_http_error_retried_to_success(model_server):
    base, schema, cache, _ = model_server
    repo = _repo(base, cache)
    with FaultPlan(FaultSpec("downloader.fetch", on_hit=1,
                             exc=urllib.error.URLError("injected reset"))
                   ) as plan:
        listed = repo.list_schemas()
    assert [s.name for s in listed] == ["tiny"]
    assert plan.triggered == [("downloader.fetch", 1, "raise")]


def test_truncated_download_never_cached_and_refetched(model_server):
    base, schema, cache, _ = model_server
    repo = _repo(base, cache)
    cache_path = os.path.join(cache.root, "tiny.npz")
    with FaultPlan(FaultSpec("downloader.payload", on_hit=1,
                             action="truncate", fraction=0.5)) as plan:
        path = repo.get_model_path(schema)
    assert plan.triggered == [("downloader.payload", 1, "truncate")]
    assert path == cache_path
    assert dl.sha256_file(cache_path) == schema.hash
    assert [f for f in os.listdir(cache.root) if ".tmp." in f] == []


def test_corrupt_cached_file_is_refetched(model_server):
    base, schema, cache, _ = model_server
    repo = _repo(base, cache)
    path = repo.get_model_path(schema)
    with open(path, "wb") as f:
        f.write(b"truncated garbage")
    assert repo.get_model_path(schema) == path
    assert dl.sha256_file(path) == schema.hash


def test_truncation_every_attempt_exhausts_retries(model_server):
    base, schema, cache, _ = model_server
    repo = _repo(base, cache, max_attempts=2)
    with FaultPlan(FaultSpec("downloader.payload", on_hit=1, times=99,
                             action="truncate", fraction=0.5)):
        with pytest.raises(IOError, match="sha256 mismatch"):
            repo.get_model_path(schema)
    assert not os.path.exists(os.path.join(cache.root, "tiny.npz"))


def test_503_retry_after_is_honored(model_server):
    """The server's Retry-After outranks the policy's own backoff."""
    base, schema, cache, handler = model_server
    handler.fail_first = 1
    slept = []
    repo = _repo(base, cache, base_delay=0.001, sleep=slept.append)
    path = repo.get_model_path(schema)
    assert slept == [0.25]
    assert handler.seen == ["/tiny.npz", "/tiny.npz"]
    assert dl.sha256_file(path) == schema.hash
    params = dl.ModelDownloader(repo).load_params("tiny")
    np.testing.assert_array_equal(params["params"]["b"], np.ones(8))


def test_parse_retry_after_header_forms():
    from email.utils import formatdate
    assert dl._parse_retry_after("120") == 120.0
    assert dl._parse_retry_after(None) is None
    assert dl._parse_retry_after("not-a-delay or date") is None
    future = formatdate(time.time() + 60, usegmt=True)
    parsed = dl._parse_retry_after(future)
    assert parsed is not None and 0.0 < parsed <= 61.0
