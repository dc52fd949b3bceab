"""The port's serving seam (``mmlspark_tpu_torch/serve/{batcher,registry,
server,http}.py``, ``reliability/{breaker,retry}.py``,
``observability/memory.py``) against the JAX package's.

Both packages serve the same ``mlp_tabular`` weights (the flax tree through
``from_jax_params``) on the same numpy rows. Everything runs on the CPU
with real sub-second concurrency or an injected clock; no test sleeps, and
every wait has a timeout. Tolerances:

- the port's served rows against its own ``TorchModel.transform``: bit for
  bit when every batch is padded to a bucket equal to ``miniBatchSize``
  (a zero-padded batch gives the same bits in its live rows as the
  unpadded batch of that shape);
- with buckets (1, 8) against ``miniBatchSize=8``: within 1e-6. torch on
  the CPU does not give the same bits for different batch shapes (rows
  scored one at a time differ from the same rows scored eight at a time by
  up to 6e-8 at these widths: the matrix product blocks differently), so
  bit-equality across buckets is not a property of the port;
- the port's served rows against the JAX ``Server``'s: within 1e-6 (two
  frameworks' fp32 products, summed in other orders).
"""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from mmlspark_tpu.models.jax_model import JaxModel
from mmlspark_tpu.reliability import breaker as jbreaker
from mmlspark_tpu.reliability import retry as jretry
from mmlspark_tpu.serve import Server as JServer
from mmlspark_tpu.serve import batcher as jbatcher
from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.observability import events, metrics
from mmlspark_tpu_torch.observability import memory as devmem
from mmlspark_tpu_torch.reliability import breaker as tbreaker
from mmlspark_tpu_torch.reliability import retry as tretry
from mmlspark_tpu_torch.reliability.faults import (
    FaultPlan, FaultSpec, InjectedFault,
)
from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.serve import (
    MicroBatcher, RequestExpired, Server, ServerClosed, ServerOverloaded,
    Ticket, bucket_for, default_buckets, parse_buckets,
)
from mmlspark_tpu_torch.serve import registry as registry_mod
from mmlspark_tpu_torch.serve.http import serve_http
from mmlspark_tpu_torch.utils import config as tconfig

CROSS_SHAPE_TOL = 1e-6
JAX_TOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu_and_fresh_metrics():
    tconfig.set("runtime.device", "cpu")
    metrics.get_registry().reset()
    tbreaker.reset_breakers()
    yield
    tconfig.unset("runtime.device")
    metrics.get_registry().reset()
    devmem.get_ledger().reset()


def jax_model(dim=8, classes=3, seed=0):
    m = JaxModel(inputCol="x", outputCol="y", miniBatchSize=8)
    return m.set_model("mlp_tabular", input_dim=dim, hidden=[16],
                       num_classes=classes, seed=seed)


def make_model(dim=8, classes=3, seed=0):
    """The port's TorchModel on the JAX model's weights."""
    jm = jax_model(dim, classes, seed)
    m = TorchModel(inputCol="x", outputCol="y", miniBatchSize=8)
    return m.set_model("mlp_tabular", params=jm._state["params"],
                       input_dim=dim, hidden=[16], num_classes=classes)


def _ticker(start=0.0):
    state = {"now": float(start)}

    def clock():
        return state["now"]
    clock.advance = lambda dt: state.__setitem__("now", state["now"] + dt)
    return clock


def _rows(n=24, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 8)).astype(np.float32)


def _direct(m, X):
    return np.asarray(m.transform(Frame.from_dict({"x": X})).column("y"))


def _concurrent(srv, X, clients=4):
    """Every row of ``X`` submitted alone, from ``clients`` threads."""
    got = np.zeros((len(X), 3), np.float32)

    def client(c):
        futs = [(i, srv.submit_async("mlp", X[i]))
                for i in range(c, len(X), clients)]
        for i, f in futs:
            got[i] = f.result(30)[0]
    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    return got


# -- the batcher core against the reference ----------------------------------

@pytest.mark.parametrize("max_batch", [1, 2, 7, 8, 64, 100])
def test_bucket_helpers_equal_the_reference(max_batch):
    assert default_buckets(max_batch) == jbatcher.default_buckets(max_batch)
    text = f"1, {max_batch}"
    assert parse_buckets(text, max_batch) \
        == jbatcher.parse_buckets(text, max_batch)
    buckets = default_buckets(max_batch)
    for rows in range(1, max_batch + 1):
        assert bucket_for(rows, buckets) == jbatcher.bucket_for(rows, buckets)
    with pytest.raises(ValueError):
        bucket_for(max_batch + 1, buckets)
    with pytest.raises(ValueError):
        parse_buckets("0,8", max_batch)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_micro_batcher_flushes_as_the_reference(seed):
    """A seeded schedule of offers (two models, 1-4 rows) and clock steps:
    the port's MicroBatcher and the JAX one agree on ready(), wait_s() and
    every group take() pops."""
    rng = np.random.default_rng(seed)
    clocks = _ticker(), _ticker()
    port = MicroBatcher(8, 0.005, clock=clocks[0])
    ref = jbatcher.MicroBatcher(8, 0.005, clock=clocks[1])
    for step in range(200):
        op = rng.integers(0, 3)
        if op == 0:
            model, rows = "ab"[rng.integers(0, 2)], int(rng.integers(1, 5))
            port.offer(Ticket(model, None, rows, None, clocks[0]()))
            ref.offer(jbatcher.Ticket(model, None, rows, None, clocks[1]()))
        elif op == 1:
            dt = float(rng.uniform(0, 0.004))
            for c in clocks:
                c.advance(dt)
        assert port.ready() == ref.ready()
        assert port.wait_s() == ref.wait_s()
        if port.ready():
            got = [(t.model, t.rows) for t in port.take()]
            want = [(t.model, t.rows) for t in ref.take()]
            assert got == want
        assert port.pending_rows == ref.pending_rows


def test_max_wait_flushes_partial_batch_injected_clock():
    clock = _ticker()
    b = MicroBatcher(max_batch=8, max_wait_s=0.005, clock=clock)
    b.offer(Ticket("m", np.zeros((2, 4), np.float32), 2, None, clock()))
    assert not b.ready()
    assert b.wait_s() == pytest.approx(0.005)
    clock.advance(0.006)
    assert b.ready()
    assert [t.rows for t in b.take()] == [2]
    assert len(b) == 0 and b.wait_s() is None


# -- served rows: the port's own transform, and the JAX server ----------------

def test_served_rows_bit_equal_transform_at_the_same_padded_shape():
    """Every batch padded to bucket 8 = miniBatchSize: concurrent single-row
    submits, and submit_many, give transform's bits."""
    m = make_model()
    X = _rows()
    direct = _direct(m, X)
    with Server({"mlp": m}, max_batch=8, max_wait_ms=2.0, queue_depth=64,
                buckets=(8,)) as srv:
        assert np.array_equal(_concurrent(srv, X), direct)
        assert np.array_equal(srv.submit_many("mlp", X, timeout=30), direct)


def test_served_rows_across_buckets_within_the_cross_shape_difference():
    """Buckets (1, 8) score some rows in batches of 1: within
    CROSS_SHAPE_TOL of transform's batches of 8 (the module docstring says
    why not bit for bit)."""
    m = make_model()
    X = _rows()
    direct = _direct(m, X)
    with Server({"mlp": m}, max_batch=8, max_wait_ms=2.0, queue_depth=64,
                buckets=(1, 8)) as srv:
        got = _concurrent(srv, X)
        one = srv.submit("mlp", X[3], timeout=30)     # a batch of 1
    assert np.abs(got - direct).max() <= CROSS_SHAPE_TOL
    assert np.abs(one[0] - direct[3]).max() <= CROSS_SHAPE_TOL


def test_served_rows_match_the_jax_server():
    X = _rows(seed=3)
    with JServer({"mlp": jax_model()}, max_batch=8, max_wait_ms=1.0,
                 buckets=(1, 8)) as jsrv:
        want = jsrv.submit_many("mlp", X, timeout=60)
    with Server({"mlp": make_model()}, max_batch=8, max_wait_ms=1.0,
                buckets=(1, 8)) as srv:
        got = srv.submit_many("mlp", X, timeout=30)
    assert got.shape == want.shape == (24, 3)
    assert np.abs(got - want).max() <= JAX_TOL


def test_single_row_1d_input_and_multi_model():
    ma, mb = make_model(seed=0), make_model(seed=1)
    x = np.arange(8, dtype=np.float32)
    with Server({"a": ma, "b": mb}, max_batch=4, max_wait_ms=1.0) as srv:
        ya = srv.submit("a", x, timeout=30)
        yb = srv.submit("b", x, timeout=30)
        assert ya.shape == (1, 3) and yb.shape == (1, 3)
        assert not np.array_equal(ya, yb)
        with pytest.raises(KeyError):
            srv.submit_async("nope", x)


# -- admission control, deadlines --------------------------------------------

def test_overload_sheds_immediately():
    srv = Server({"mlp": make_model()}, max_batch=4, max_wait_ms=1.0,
                 queue_depth=2, start=False)
    try:
        x = np.zeros(8, np.float32)
        f1, f2 = srv.submit_async("mlp", x), srv.submit_async("mlp", x)
        with pytest.raises(ServerOverloaded):
            srv.submit_async("mlp", x)
        assert srv.stats()["shed"] == 1 and srv.stats()["admitted"] == 2
        srv.close(drain=False)
        for f in (f1, f2):
            with pytest.raises(ServerOverloaded):
                f.result(0)
        with pytest.raises(ServerClosed):
            srv.submit_async("mlp", x)
    finally:
        srv.close(drain=False)


@pytest.mark.parametrize("exc,want", [
    (ServerOverloaded("full"), True),
    (RequestExpired("late"), False),
    (ServerClosed("closed"), False),
    (tbreaker.CircuitOpen("k", 1.0), True),
    (ConnectionError("reset"), True),
    (ValueError("bad"), False),
])
def test_default_retryable_classifies_as_the_reference(exc, want):
    assert tretry.default_retryable(exc) is want
    assert jretry.default_retryable(exc) is want


def test_overloaded_retries_under_the_port_policy():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise ServerOverloaded("queue full", retry_after=0.0)
        return "ok"
    slept = []
    policy = tretry.RetryPolicy(max_attempts=3, base_delay=0.0, jitter=0.0,
                                sleep=slept.append)
    assert policy.call(flaky) == "ok"
    assert calls["n"] == 3 and slept == [0.0, 0.0]


@pytest.mark.parametrize("seed", [0, 5, 17])
def test_retry_backoff_schedule_equals_the_reference(seed):
    kw = dict(max_attempts=6, base_delay=0.2, max_delay=3.0, jitter=0.25,
              seed=seed)
    port, ref = tretry.RetryPolicy(**kw), jretry.RetryPolicy(**kw)
    assert [port.delay(n) for n in range(1, 7)] \
        == [ref.delay(n) for n in range(1, 7)]


def test_circuit_breaker_transitions_as_the_reference():
    clocks = _ticker(), _ticker()
    port = tbreaker.CircuitBreaker("p", failure_threshold=2,
                                   reset_timeout_s=1.0, clock=clocks[0])
    ref = jbreaker.CircuitBreaker("r", failure_threshold=2,
                                  reset_timeout_s=1.0, clock=clocks[1])
    script = ["fail", "fail", "allow", "tick", "allow", "allow", "fail",
              "tick", "allow", "ok", "allow"]
    for op in script:
        got = []
        for br, clock in ((port, clocks[0]), (ref, clocks[1])):
            if op == "fail":
                br.record_failure()
            elif op == "ok":
                br.record_success()
            elif op == "tick":
                clock.advance(1.5)
            got.append((br.allow() if op == "allow" else None, br.state))
        assert got[0] == got[1], op


def test_expired_requests_cancelled_not_computed(monkeypatch):
    clock = _ticker()
    srv = Server({"mlp": make_model()}, max_batch=4, max_wait_ms=1.0,
                 clock=clock, start=False)
    scored = []
    orig = registry_mod.ModelEntry.score
    monkeypatch.setattr(registry_mod.ModelEntry, "score",
                        lambda self, x: scored.append(x.shape) or
                        orig(self, x))
    try:
        x = np.zeros(8, np.float32)
        late = srv.submit_async("mlp", x, deadline_ms=50.0)
        ok = srv.submit_async("mlp", x)
        clock.advance(0.2)
        srv.close(drain=True)
        with pytest.raises(RequestExpired):
            late.result(0)
        assert ok.result(0).shape == (1, 3)
        assert srv.stats()["expired"] == 1
        assert scored == [(1, 8)]          # never a 2-row group
    finally:
        srv.close(drain=False)


def test_default_deadline_from_config():
    clock = _ticker()
    tconfig.set("serving.default_deadline_ms", 10.0)
    srv = Server({"mlp": make_model()}, max_batch=4, clock=clock,
                 start=False)
    try:
        f = srv.submit_async("mlp", np.zeros(8, np.float32))
        clock.advance(1.0)
        srv.close(drain=True)
        with pytest.raises(RequestExpired):
            f.result(0)
    finally:
        srv.close(drain=False)
        tconfig.unset("serving.default_deadline_ms")


def test_pump_drives_a_stopped_server():
    srv = Server({"mlp": make_model()}, max_batch=4, start=False)
    try:
        futs = [srv.submit_async("mlp", np.full(8, i, np.float32))
                for i in range(6)]
        assert srv.pump(max_batches=1) == 1
        assert sum(f.done() for f in futs) == 4
        assert srv.pump() == 1
        assert all(f.result(0).shape == (1, 3) for f in futs)
    finally:
        srv.close()


def test_drain_stops_admission_and_health_reports_it():
    srv = Server({"mlp": make_model()}, max_batch=4, start=False)
    assert srv.health() == {"live": True, "ready": True, "state": "ready"}
    f = srv.submit_async("mlp", np.zeros(8, np.float32))
    srv.drain(timeout_s=5.0)
    assert f.result(0).shape == (1, 3)          # admitted work finished
    assert srv.health()["state"] == "closed"
    with pytest.raises(ServerClosed):
        srv.submit_async("mlp", np.zeros(8, np.float32))


# -- program discipline, residency --------------------------------------------

def test_at_most_one_program_per_bucket(monkeypatch):
    built = []
    orig = registry_mod.ModelEntry._compile

    def spy(self, bucket, row_shape, dtype):
        built.append(bucket)
        return orig(self, bucket, row_shape, dtype)
    monkeypatch.setattr(registry_mod.ModelEntry, "_compile", spy)
    rng = np.random.default_rng(1)
    with Server({"mlp": make_model()}, max_batch=8, max_wait_ms=1.0,
                buckets=(1, 4, 8)) as srv:
        for rows in [1, 3, 2, 1, 4, 8, 5, 1, 7, 2] * 3:
            y = srv.submit("mlp", rng.normal(size=(rows, 8)), timeout=30)
            assert y.shape == (rows, 3)
        assert srv.stats()["registry.compiles"] == len(built)
    assert set(built) <= {1, 4, 8}
    assert len(built) == len(set(built)), f"rebuilt a bucket: {built}"


def test_registry_lru_eviction_under_budget():
    ma, mb = make_model(seed=0), make_model(seed=1)
    reg = registry_mod.ModelRegistry(budget_mb=1e-9)
    ea, eb = reg.add("a", ma), reg.add("b", mb)
    ea.ensure_apply()
    reg.touch(ea)
    assert ea.warm
    eb.ensure_apply()
    reg.touch(eb)
    assert eb.warm and not ea.warm
    assert reg.stats()["evictions"] == 1
    assert ma._build_cache is None               # placed module dropped
    assert devmem.get_ledger().total("a") == 0
    assert devmem.get_ledger().total("b") == eb.resident_bytes() > 0
    ea.ensure_apply()
    assert ea.warm


def test_registry_bytes_match_the_state_and_release_clears_the_ledger():
    m = make_model()
    with Server({"mlp": m}, max_batch=4) as srv:
        srv.submit("mlp", np.zeros(8, np.float32), timeout=30)
        want = sum(np.asarray(v).nbytes for v in m._state["params"].values())
        assert srv.stats()["registry.resident_bytes"] == want
        assert devmem.get_ledger().total("mlp", "params") == want
        assert srv.registry.projected_bytes(m) == want
    assert devmem.get_ledger().total("mlp") == 0


def test_split_param_bytes_puts_embeddings_in_the_table_kind():
    state = {"token_embedding.embedding": np.zeros((10, 4), np.float32),
             "pos_embedding": np.zeros((1, 6, 4), np.float32),
             "block0.attn_query.weight": np.zeros((4, 4), np.float32)}
    assert devmem.split_param_shard_bytes(state) == (64, 256)
    assert devmem.param_bytes(state) == 320
    # over a mesh of data 2 x tensor 2 the table's rows and the query's
    # output features split over tensor; the position table stays whole
    assert devmem.projected_shard_bytes(
        state, mesh={"data": 2, "tensor": 2}) == 20 * 4 + 96 + 8 * 4


# -- fault sites, metrics, events ---------------------------------------------

def test_fault_site_score_fails_batch_not_server():
    with Server({"mlp": make_model()}, max_batch=4, max_wait_ms=1.0) as srv:
        x = np.zeros(8, np.float32)
        with FaultPlan(FaultSpec("serve.score", on_hit=1)):
            with pytest.raises(InjectedFault):
                srv.submit("mlp", x, timeout=30)
        assert srv.submit("mlp", x, timeout=30).shape == (1, 3)
        assert srv.stats()["failed"] == 1


@pytest.mark.parametrize("site", ["serve.enqueue", "serve.batch"])
def test_fault_sites_before_scoring(site):
    srv = Server({"mlp": make_model()}, max_batch=4, start=False)
    try:
        with FaultPlan(FaultSpec(site, on_hit=1)):
            if site == "serve.enqueue":
                with pytest.raises(InjectedFault):
                    srv.submit_async("mlp", np.zeros(8, np.float32))
                assert srv.stats()["admitted"] == 0
            else:
                f = srv.submit_async("mlp", np.zeros(8, np.float32))
                srv.pump()
                with pytest.raises(InjectedFault):
                    f.result(0)
    finally:
        srv.close(drain=False)


def test_metrics_counters_and_hot_instruments():
    tconfig.set("observability.metrics", True)
    try:
        with Server({"mlp": make_model()}, max_batch=4,
                    max_wait_ms=1.0) as srv:
            srv.submit("mlp", np.zeros(8, np.float32), timeout=30)
        dump = metrics.get_registry().to_dict()
        assert dump["serving.admitted"]["value"] == 1
        assert dump["serving.completed"]["value"] == 1
        assert dump["serving.total_ms"]["count"] == 1
        assert dump["serving.compute_ms"]["count"] == 1
        assert 0.0 < dump["serving.batch_occupancy"]["value"] <= 1.0
    finally:
        tconfig.unset("observability.metrics")


def test_events_log_requests_sheds_and_slow_traces(tmp_path):
    path = tmp_path / "events.jsonl"
    tconfig.set("observability.events_path", str(path))
    tconfig.set("observability.trace_slow_ms", 1e-9)   # every request slow
    try:
        with Server({"mlp": make_model()}, max_batch=4,
                    max_wait_ms=1.0) as srv:
            srv.submit_many("mlp", _rows(6), timeout=30)
        with Server({"mlp": make_model()}, queue_depth=1,
                    start=False) as srv2:
            srv2.submit_async("mlp", np.zeros(8, np.float32))
            with pytest.raises(ServerOverloaded):
                srv2.submit_async("mlp", np.zeros(8, np.float32))
    finally:
        events.close()
        tconfig.unset("observability.events_path")
        tconfig.unset("observability.trace_slow_ms")
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    reqs = [e for e in lines if (e["type"], e["name"])
            == ("serving", "request")]
    assert len(reqs) == 3
    assert {"queue_ms", "pad_ms", "compute_ms", "total_ms", "bucket",
            "occupancy", "trace_id"} <= set(reqs[0])
    assert sum((e["type"], e["name"]) == ("serving", "shed")
               for e in lines) == 1
    roots = [e for e in lines if (e["type"], e["name"])
             == ("span", "serve:request")]
    kids = [e for e in lines if e["type"] == "span"
            and e.get("parent_id") == roots[0]["span_id"]]
    assert len(roots) == 3 and len(kids) == 3


# -- HTTP front end ----------------------------------------------------------

def _post(addr, payload, path="/score"):
    req = urllib.request.Request(f"http://{addr}{path}",
                                 data=json.dumps(payload).encode())
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _get(addr, path):
    with urllib.request.urlopen(f"http://{addr}{path}", timeout=30) as r:
        return r.status, r.read().decode()


def test_http_roundtrip_and_error_mapping():
    x = [[0.0] * 8]
    with Server({"mlp": make_model()}, max_batch=4, max_wait_ms=1.0) as srv:
        direct = srv.submit("mlp", np.asarray(x, np.float32), timeout=30)
        httpd, addr = serve_http(srv, port=0)
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        try:
            got = _post(addr, {"model": "mlp", "x": x})
            assert np.array_equal(np.asarray(got["y"], np.float32), direct)
            one = _post(addr, {"model": "mlp", "x": x[0]})   # a 1-D row
            assert np.array_equal(np.asarray(one["y"], np.float32), direct)
            assert one["trace_id"].startswith("t-")
            many = _post(addr, {"model": "mlp", "x": x * 3})
            assert np.asarray(many["y"]).shape == (3, 3)
            health = json.loads(_get(addr, "/healthz")[1])
            assert health["status"] == "ok"
            assert health["stats"]["completed"] >= 2
            assert json.loads(_get(addr, "/models")[1]) == {
                "models": ["mlp"], "versions": {"mlp": "v1"}}
            assert _get(addr, "/livez")[0] == _get(addr, "/readyz")[0] == 200
            assert "serving_admitted" in _get(addr, "/metrics")[1]
            for bad in ({"model": "nope", "x": x}, {"x": x}):
                with pytest.raises(urllib.error.HTTPError) as ei:
                    _post(addr, bad)
                assert ei.value.code == 400
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(addr, {"model": "mlp", "x": x}, path="/nope")
            assert ei.value.code == 404
        finally:
            httpd.shutdown()
            httpd.server_close()
            t.join(timeout=30)


@pytest.mark.parametrize("retry_after,header", [(0.0, "0"), (2.5, "2.5")])
def test_http_maps_overload_to_503_with_retry_after(retry_after, header):
    tconfig.set("serving.retry_after_s", retry_after)
    srv = Server({"mlp": make_model()}, queue_depth=1, start=False)
    srv.submit_async("mlp", np.zeros(8, np.float32))
    httpd, addr = serve_http(srv, port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(addr, {"model": "mlp", "x": [[0.0] * 8]})
        assert ei.value.code == 503
        assert ei.value.headers["Retry-After"] == header
        body = json.loads(ei.value.read())
        assert body["retryable"] is True
        assert body["retry_after"] == retry_after
    finally:
        tconfig.unset("serving.retry_after_s")
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=30)
        srv.close(drain=False)


def test_http_maps_expired_to_504_and_draining_readyz_to_503():
    clock = _ticker()
    srv = Server({"mlp": make_model()}, clock=clock, start=False)
    httpd, addr = serve_http(srv, port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        out = {}

        def call():
            try:
                _post(addr, {"model": "mlp", "x": [0.0] * 8,
                             "deadline_ms": 1.0})
            except urllib.error.HTTPError as e:
                out["code"] = e.code
        caller = threading.Thread(target=call, daemon=True)
        caller.start()
        for _ in range(3000):              # at most 30 s for the admission
            if srv.stats()["admitted"] >= 1 or not caller.is_alive():
                break
            caller.join(timeout=0.01)
        assert srv.stats()["admitted"] == 1
        clock.advance(1.0)
        srv.pump()
        caller.join(timeout=30)
        assert out["code"] == 504
        srv._draining = True
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(addr, "/readyz")
        assert ei.value.code == 503
        assert _get(addr, "/livez")[0] == 200
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=30)
        srv.close(drain=False)
