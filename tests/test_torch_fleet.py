"""The port's in-process fleet (``mmlspark_tpu_torch/serve/{router,
affinity,fleet}.py``, ``observability/{aggregate,report}.py``) against the
JAX package's.

The routing layers are host logic copied from the reference, so their
choices must be EQUAL on the same script: the smooth-WRR order, tenant
shares and throttles, consistent-hash ring assignments under membership
churn, digest scores and ``AffinityState.select``, the parsed Prometheus
text. The fleet itself runs the port's ``Server`` replicas on the CPU
(``runtime.device="cpu"``): scores bit-identical to one ``Server``, a kill
discovered by failover, a rollout with zero failed requests, a canary
abort, a failover restart on the warmest survivor that replays the same
tokens, and captures only at warm-up (``scale_up`` and ``rollout``
included). Clocks are injected where the reference injects them; no
assertion waits on wall time.
"""
import json
import threading

import numpy as np
import pytest

from mmlspark_tpu.observability import aggregate as jaggregate
from mmlspark_tpu.observability import metrics as jmetrics
from mmlspark_tpu.serve import affinity as jaffinity
from mmlspark_tpu.serve import router as jrouter
from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.observability import aggregate, metrics, report
from mmlspark_tpu_torch.serve import (
    Fleet, HttpReplica, ReplicaUnavailable, RequestExpired, Router, Server,
    ServerOverloaded, TenantThrottled, WeightedFairAdmission,
)
from mmlspark_tpu_torch.serve.affinity import (
    AffinityState, ConsistentHashRing, PrefixDigest, score_digest,
)
from mmlspark_tpu_torch.serve.kvcache import prefix_block_hashes
from mmlspark_tpu_torch.serve.router import (
    _parse_retry_after, parse_tenant_weights,
)
from mmlspark_tpu_torch.utils import config as tconfig

_LANE = {"generate.max_seq_len": 64, "generate.max_sequences": 4,
         "generate.kv_block_tokens": 8, "fleet.affinity_prewarm": 0}


@pytest.fixture(autouse=True)
def _cpu_fleet():
    tconfig.set("runtime.device", "cpu")
    for k, v in _LANE.items():
        tconfig.set(k, v)
    metrics.get_registry().reset()
    yield
    for k in tuple(_LANE) + ("runtime.device",
                             "fleet.affinity_spill_factor"):
        tconfig.unset(k)
    metrics.get_registry().reset()


def _ticker(start=0.0):
    state = {"now": float(start)}

    def clock():
        return state["now"]
    clock.advance = lambda dt: state.__setitem__("now", state["now"] + dt)
    return clock


class FakeReplica:
    """Scripted Replica-protocol backend: records every call, raises what
    the test queued in ``fail`` (popped per call), runs ``on_call`` first."""

    def __init__(self, name, fail=None, capacity_rows=8):
        self.name = name
        self.capacity_rows = capacity_rows
        self.calls = []              # (model, deadline_ms, trace_id)
        self.fail = list(fail or [])
        self.on_call = None
        self._health = {"live": True, "ready": True, "state": "ready"}

    def submit(self, model, x, deadline_ms=None, trace_id=""):
        self.calls.append((model, deadline_ms, trace_id))
        if self.on_call is not None:
            self.on_call()
        if self.fail:
            raise self.fail.pop(0)
        return np.asarray(x, np.float32) * 2

    def submit_generate(self, model, prompt, max_new_tokens=None, **kw):
        self.calls.append((model, kw.get("deadline_ms"),
                           kw.get("trace_id")))
        if self.fail:
            raise self.fail.pop(0)
        return {"tokens": [1, 2], "replica": self.name}

    def health(self):
        return dict(self._health)

    def models(self):
        return ["m"]


def _routers(names, **kw):
    """The port's router and the reference's over fresh fakes."""
    kw.setdefault("failover_delay_s", 0.0)
    kw.setdefault("sleep", lambda s: None)
    return (Router([FakeReplica(n) for n in names], **kw),
            jrouter.Router([FakeReplica(n) for n in names], **kw))


X1 = np.ones((1, 4), np.float32)


# -- routing choices equal the reference's ------------------------------------

@pytest.mark.parametrize("weights", [(1, 1, 1), (3, 1, 2), (0, 2, 5)])
def test_smooth_wrr_order_equals_the_reference(weights):
    """The same submits and weight changes give the same replica order."""
    names = ["r0", "r1", "r2"]
    logs = []
    for r in _routers(names):
        r.route_log = log = []
        for n, w in zip(names, weights):
            r.set_weight(n, float(w))
        for i in range(12):
            r.submit("m", X1)
            if i == 5:
                r.set_weight("r1", 0.0)
        logs.append(log)
    assert logs[0] == logs[1] and len(logs[0]) == 12


def test_tenant_shares_and_throttles_equal_the_reference():
    """Shares, throttle decisions and the vtime lead follow the same
    stride arithmetic on a seeded admit/release schedule."""
    weights = {"gold": 3.0, "silver": 2.0, "free": 1.0}
    fas = [WeightedFairAdmission(16, weights=weights),
           jrouter.WeightedFairAdmission(16, weights=weights)]
    rng = np.random.default_rng(0)
    trail = [[], []]
    for _ in range(200):
        tenant = str(rng.choice(["gold", "silver", "free", "other"]))
        rows = int(rng.integers(1, 4))
        release = bool(rng.integers(0, 3) == 0)
        for fa, out in zip(fas, trail):
            if release:
                fa.release(tenant, rows)
                out.append(("r", tenant, fa.share(tenant)))
                continue
            try:
                fa.admit(tenant, rows)
                out.append(("a", tenant, fa.share(tenant)))
            except Exception as e:      # TenantThrottled of either package
                out.append(("t", tenant, type(e).__name__))
    assert trail[0] == trail[1]
    assert fas[0].stats() == fas[1].stats()
    assert any(t[0] == "t" for t in trail[0])
    assert parse_tenant_weights("gold=3, free=1") \
        == jrouter.parse_tenant_weights("gold=3, free=1")


@pytest.mark.parametrize("seed,vnodes", [(0, 64), (7, 16)])
def test_ring_assignments_under_churn_equal_the_reference(seed, vnodes):
    """Assignments equal the reference's before and after a replica
    retires and another joins; only the retired replica's keys move."""
    keys = [f"sess{i}" for i in range(300)]
    sets = [[f"r{i}" for i in range(4)], ["r0", "r2", "r3"],
            ["r0", "r2", "r3", "r4"]]
    got = [[ConsistentHashRing(n, vnodes=vnodes, seed=seed).assign(k)
            for k in keys] for n in sets]
    want = [[jaffinity.ConsistentHashRing(n, vnodes=vnodes,
                                          seed=seed).assign(k)
             for k in keys] for n in sets]
    assert got == want
    assert all(b == a for a, b in zip(got[0], got[1]) if a != "r1")
    assert ConsistentHashRing([], vnodes=4, seed=0).assign("k") is None


def _hashes(prompt, model="lm"):
    return prefix_block_hashes(model, "float32", prompt, 8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_score_digest_and_select_equal_the_reference(seed):
    """Random digests over shared and diverging chains: every score and
    every ``select`` (prefix, session and WRR modes) equal the
    reference's."""
    rng = np.random.default_rng(seed)
    base = [int(t) for t in rng.integers(0, 256, 48)]
    states = [AffinityState(enabled=True, min_depth=1, vnodes=16, seed=3),
              jaffinity.AffinityState(enabled=True, min_depth=1, vnodes=16,
                                      seed=3)]
    for r in range(4):
        depth = int(rng.integers(0, 7))
        fork = base[:8 * depth] + [int(t) for t in rng.integers(0, 256, 8)]
        h = _hashes(fork)
        chains = [{"chain": h[-1], "hashes": h, "depth": len(h)}] if h \
            else []
        for st in states:
            st.update_digest(f"r{r}", "lm", chains, kv_dtype="float32",
                             block_tokens=8)
    names = [f"r{i}" for i in range(4)]
    for trial in range(20):
        prompt = base[:int(rng.integers(1, 48))]
        session = f"s{trial}" if trial % 3 == 0 else None
        cands = [n for n in names if rng.integers(0, 4)]
        picks = []
        for st, mod in ((states[0], None), (states[1], jaffinity)):
            hint = st.hint_for("lm", prompt, session)
            score = [score_digest(st.digest_for(n, "lm"), _hashes(prompt))
                     if mod is None else
                     mod.score_digest(st.digest_for(n, "lm"),
                                      _hashes(prompt)) for n in names]
            picks.append((score, st.select(cands, hint)
                          if hint is not None else None))
        assert picks[0] == picks[1]
    assert states[0].stats()["digests"] == 4
    assert score_digest(None, _hashes(base)) == 0
    d = PrefixDigest("r9", "lm", [], kv_dtype="float32", block_tokens=8)
    assert d.max_depth() == 0 and d.to_dict()["replica"] == "r9"


# -- failover and shed (injected clock) ---------------------------------------

def test_failover_keeps_the_trace_id_and_the_remaining_deadline():
    clock = _ticker(100.0)
    dying = FakeReplica("rz", fail=[ReplicaUnavailable("boom")])
    dying.on_call = lambda: clock.advance(0.02)   # dies 20 ms in
    healthy = FakeReplica("ra")
    r = Router([dying, healthy], failover_attempts=2, clock=clock,
               failover_delay_s=0.0, sleep=lambda s: None)
    np.testing.assert_array_equal(r.submit("m", X1, deadline_ms=50.0),
                                  X1 * 2)
    assert len(dying.calls) == 1 and len(healthy.calls) == 1
    assert r.stats()["failovers"] == 1
    tid_a, tid_b = dying.calls[0][2], healthy.calls[0][2]
    assert tid_a and tid_a == tid_b
    assert dying.calls[0][1] == pytest.approx(50.0)
    assert healthy.calls[0][1] == pytest.approx(30.0)
    assert r.stats()["replicas"]["rz"]["state"] == "dead"
    # a failover that would start past the deadline expires instead
    late = FakeReplica("rz", fail=[ReplicaUnavailable("boom")])
    late.on_call = lambda: clock.advance(0.02)
    spare = FakeReplica("ra")
    r2 = Router([late, spare], failover_attempts=2, clock=clock,
                failover_delay_s=0.0, sleep=lambda s: None)
    with pytest.raises(RequestExpired):
        r2.submit("m", X1, deadline_ms=10.0)
    assert spare.calls == []


def test_all_shed_consolidates_to_the_minimum_retry_after():
    a = FakeReplica("ra", fail=[ServerOverloaded("full", retry_after=2.5)])
    b = FakeReplica("rb", fail=[ServerOverloaded("full", retry_after=0.5)])
    r = Router([a, b], failover_delay_s=0.0, sleep=lambda s: None)
    with pytest.raises(ServerOverloaded) as ei:
        r.submit_generate("m", [1, 2, 3], 4)
    assert ei.value.retry_after == 0.5 and ei.value.retryable
    assert not isinstance(ei.value, TenantThrottled)
    s = r.stats()
    assert s["all_shed"] == 1 and s["failovers"] == 0
    assert all(v["breaker"] == "closed" for v in s["replicas"].values())
    assert _parse_retry_after("1.5") == 1.5
    assert _parse_retry_after("soon") is None
    assert _parse_retry_after(None) is None


# -- metrics helpers and the scrape text --------------------------------------

def test_metrics_helpers_equal_the_reference():
    vals = sorted(np.random.default_rng(0).uniform(0, 9, 37).tolist())
    cum = {"0.5": 1, "1.0": 4, "2.5": 9, "+Inf": 12}
    for p in (0, 37, 50, 90, 99, 100):
        assert metrics.nearest_rank(vals, p) == jmetrics.nearest_rank(vals, p)
        assert metrics.percentile_from_buckets_ex(cum, p) \
            == jmetrics.percentile_from_buckets_ex(cum, p)
    assert metrics.percentile_from_buckets_ex(cum, 99) == (2.5, True)
    for v in ('plain', 'a"b', "back\\slash", "new\nline"):
        assert metrics.escape_label_value(v) == jmetrics.escape_label_value(v)


def test_aggregated_prometheus_text_round_trips_like_the_reference():
    reg = aggregate.AggregatedRegistry()
    jreg = jaggregate.AggregatedRegistry()
    for rg in (reg, jreg):
        rg.set_value("serving.completed", {"replica": "r0"}, 7, "counter")
        rg.set_value("serving.queue_depth", {"replica": 'r"1'}, 2.5)
        rg.set_histogram("serving.total_ms", {"replica": "r0"},
                         {"1.0": 2, "5.0": 3, "+Inf": 4}, 9.5, 4)
    text = reg.prometheus_text()
    assert text == jreg.prometheus_text()
    assert aggregate.parse_prometheus_text(text) \
        == jaggregate.parse_prometheus_text(text)
    single = metrics.MetricsRegistry()
    single.counter("serving.admitted").inc(3)
    single.histogram("serving.total_ms").observe(2.0)
    parsed = aggregate.parse_prometheus_text(single.prometheus_text())
    assert parsed["serving_admitted"] == {"type": "counter", "value": 3.0}
    assert parsed["serving_total_ms"]["count"] == 1.0
    assert aggregate.merge_cumulative([{"1": 1, "+Inf": 2},
                                       {"1": 2, "+Inf": 2}]) \
        == {"1": 3.0, "+Inf": 4.0}


def test_event_logs_merge_in_ts_order_and_count_torn_lines(tmp_path):
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    a.write_text(json.dumps({"ts": 2.0, "name": "x"}) + "\n"
                 + json.dumps({"ts": 4.0, "name": "y"}) + "\n{torn")
    b.write_text(json.dumps({"ts": 3.0, "name": "z"}) + "\n\n")
    merged = aggregate.merge_event_logs(
        aggregate.expand_event_paths([str(a)], str(tmp_path / "b*")))
    assert [e["name"] for e in merged] == ["x", "z", "y"]
    assert metrics.counter("events.torn_lines").value == 1
    assert report.load_events(str(b)) == [{"ts": 3.0, "name": "z"}]


# -- the fleet on the CPU ------------------------------------------------------

def make_mlp(seed=0):
    m = TorchModel(inputCol="x", outputCol="y", miniBatchSize=8)
    return m.set_model("mlp_tabular", input_dim=8, hidden=[16],
                       num_classes=3, seed=seed)


def test_fleet_scores_bit_identical_and_survives_a_kill():
    m = make_mlp()
    X = [np.random.default_rng(i).normal(size=(2, 8)).astype(np.float32)
         for i in range(9)]
    with Server({"mlp": m}, max_batch=4) as ref:
        want = [ref.submit("mlp", x, timeout=30) for x in X]
    with Fleet({"mlp": m}, replicas=3,
               server_kwargs={"max_batch": 4}) as fleet:
        got = [fleet.submit("mlp", x) for x in X[:3]]
        fleet.kill(0)                    # no drain, router not told
        fleet.kill(0)                    # idempotent
        got += [fleet.submit("mlp", x) for x in X[3:]]
        stats = fleet.stats()
        assert fleet.router.probe()["r0"] == "dead"
        h = fleet.health()
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert stats["failovers"] >= 1
    assert stats["servers"]["r1"]["completed"] > 0
    assert h["live"] and h["ready"] and h["replicas"]["r0"] == "dead"


def test_http_replica_against_the_ports_serve_http():
    from mmlspark_tpu_torch.serve.http import serve_http
    with Server({"mlp": make_mlp()}, max_batch=4, max_wait_ms=1.0) as srv:
        direct = srv.submit("mlp", np.zeros((1, 8), np.float32), timeout=30)
        httpd, addr = serve_http(srv, port=0)
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        try:
            rep = HttpReplica(addr, name="remote")
            np.testing.assert_array_equal(
                rep.submit("mlp", [[0.0] * 8], trace_id="t-1"), direct)
            assert rep.health() == {"live": True, "ready": True,
                                    "state": "ready"}
            assert rep.models() == ["mlp"]
            assert rep.probe_livez() and rep.probe_readyz()
            with pytest.raises(ValueError):      # 400: client error
                rep.submit("nope", [[0.0] * 8])
            # the router fronts it like an in-process replica
            r = Router([rep], failover_delay_s=0.0)
            np.testing.assert_array_equal(r.submit("mlp", [[0.0] * 8]),
                                          direct)
            snap = aggregate.FleetScraper([rep]).scrape()
            assert snap["replicas"]["remote"]["ready"]
        finally:
            httpd.shutdown()
            httpd.server_close()
    dead = HttpReplica("127.0.0.1:9", name="dead", timeout_s=0.5)
    with pytest.raises(ReplicaUnavailable):
        dead.submit("mlp", [[0.0] * 8])
    assert dead.health() == {"live": False, "ready": False, "state": "dead"}


def test_http_replica_maps_503_to_overload():
    from mmlspark_tpu_torch.serve.http import serve_http
    srv = Server({"mlp": make_mlp()}, queue_depth=1, start=False)
    srv.submit_async("mlp", np.zeros(8, np.float32))
    httpd, addr = serve_http(srv, port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        with pytest.raises(ServerOverloaded) as ei:
            HttpReplica(addr).submit("mlp", [[0.0] * 8])
        assert not isinstance(ei.value, ReplicaUnavailable)
        assert ei.value.retry_after is not None
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close(drain=False)


def test_rollout_is_zero_downtime_and_leaves_no_stale_version():
    m1, m2 = make_mlp(seed=0), make_mlp(seed=1)
    x = np.zeros((1, 8), np.float32)
    with Server({"mlp": m2}, max_batch=4) as ref:
        want_v2 = ref.submit("mlp", x, timeout=30)
    fleet = Fleet({"mlp": m1}, replicas=3, server_kwargs={"max_batch": 4})
    errs, stop = [], threading.Event()

    def fire():
        while not stop.is_set():
            try:
                fleet.submit("mlp", x)
            except Exception as e:       # any client-visible failure = red
                errs.append(e)
                return

    try:
        fleet.kill(1)                    # rollout must skip the dead one
        t = threading.Thread(target=fire, daemon=True)
        t.start()
        report_ = fleet.rollout("mlp", m2, "v2", warm_x=x)
        stop.set()
        t.join(timeout=10)
        assert errs == []
        assert [r["status"] for r in report_["replicas"]] == \
            ["updated", "skipped_dead", "updated"]
        assert report_["versions"] == {"r0": {"mlp": "v2"},
                                       "r2": {"mlp": "v2"}}
        for _ in range(4):
            np.testing.assert_array_equal(fleet.submit("mlp", x), want_v2)
    finally:
        stop.set()
        fleet.close()


def test_rollout_canary_aborts_and_restores_rotation():
    x = np.zeros((1, 8), np.float32)
    with Fleet({"mlp": make_mlp()}, replicas=2,
               server_kwargs={"max_batch": 4}) as fleet:
        with pytest.raises(Exception):
            fleet.rollout("mlp", object(), "v2", warm_x=x)
        assert fleet.router._handles["r0"].weight == 1.0
        assert fleet.servers[1].registry.versions() == {"mlp": "v1"}
        fleet.submit("mlp", x)
        # a 2x1 placement needs two ranks led from this process
        with pytest.raises(RuntimeError, match="process group"):
            fleet.reshard("2x1")


# -- the generate lane behind the fleet -----------------------------------------

def make_lm(seed=0):
    return TorchModel().set_model("transformer_lm_tiny", seed=seed, dim=32)


PROMPT = list(range(32)) + [3, 4]            # 4 full blocks + a tail


def test_failover_restarts_on_the_warmest_survivor_token_identical():
    """The leader (deepest advertised chain) dies; the retry re-scores the
    survivors from a real scrape, lands on the warmer one (depth 2 over a
    cold replica) and replays the same tokens under seeded sampling."""
    lm = make_lm()
    ref = Server({"lm": lm})
    try:
        want = ref.submit_generate("lm", PROMPT, 6, seed=5,
                                   temperature=0.8, top_k=4).result()
    finally:
        ref.close()
    fleet = Fleet({"lm": lm}, replicas=3, failover_delay_s=0.0)
    try:
        fleet.replicas[0].server.submit_generate(
            "lm", PROMPT, 1, seed=5).result()
        fleet.replicas[1].server.submit_generate(
            "lm", PROMPT[:16] + [9], 1, seed=5).result()
        aggregate.FleetScraper(fleet).scrape()
        aff = fleet.router.affinity
        assert score_digest(aff.digest_for("r0", "lm"), _hashes(PROMPT)) \
            == 4
        assert score_digest(aff.digest_for("r1", "lm"), _hashes(PROMPT)) \
            == 2
        fleet.router.route_log = log = []
        fleet.kill(0)                              # the leader dies
        out = fleet.submit_generate("lm", PROMPT, 6, seed=5,
                                    temperature=0.8, top_k=4)
    finally:
        fleet.close()
    assert log == ["r1"]
    assert out["tokens"] == want["tokens"]
    assert fleet.router.stats()["failovers"] >= 1
    assert fleet.router.affinity.stats()["routes_prefix"] == 2  # r0, then r1


def _captures(fleet):
    return {r.name: r.server.registry.stats()["compiles"]
            for r in fleet.replicas if not r._dead}


def test_scale_up_and_rollout_capture_only_at_warm_up():
    """A replica added by ``scale_up`` builds every program a live
    replica holds before it enters the router, and a generate rollout
    rebuilds the lane over the new version at its warm step: traffic
    afterwards builds nothing, and the served tokens are the new
    version's."""
    lm0, lm1 = make_lm(0), make_lm(1)
    prompts = [PROMPT, [5, 9, 17], list(range(40, 60))]
    ref = Server({"lm": lm1}, start=False)
    try:
        lane = ref.enable_generate("lm", start=False)
        futs = [ref.submit_generate("lm", p, 4) for p in prompts]
        for _ in range(32):
            if all(f.done() for f in futs):
                break
            lane.step()
        want_v1 = [f.result(1)["tokens"] for f in futs]
    finally:
        ref.close()
    with Fleet({"lm": lm0}, replicas=2, failover_delay_s=0.0) as fleet:
        for rep in fleet.replicas:          # warm both founding replicas:
            for p in prompts * 2:           # cold prefills, then prefix
                rep.server.submit_generate("lm", p, 4).result()   # hits
        warm = _captures(fleet)
        name = fleet.scale_up()
        warm.update(_captures(fleet))
        assert warm[name] == warm["r0"] > 0
        for p in prompts * 2:
            fleet.submit_generate("lm", p, 4)
        assert _captures(fleet) == warm
        rep = fleet.rollout("lm", lm1, "v2")
        assert [r["status"] for r in rep["replicas"]] == ["updated"] * 3
        after = _captures(fleet)
        assert all(r["captures"] == after[r["replica"]]
                   for r in rep["replicas"])
        got = [fleet.submit_generate("lm", p, 4)["tokens"] for p in prompts]
        assert got == want_v1
        assert _captures(fleet) == after
        assert fleet.stats()["failovers"] == 0


class _FlakyReplica:
    """A duck-typed scrape target whose health call can be made to fail."""

    def __init__(self, name):
        self.name = name
        self.failing = False

    def health(self):
        if self.failing:
            raise ConnectionError("refused")
        return {"live": True, "ready": True, "state": "ready"}


def test_fleet_scraper_merges_the_replicas_and_trips_its_breaker():
    """In-process scrapes merge each replica's twins into fleet totals and
    one labeled exposition that parses back; a failing target trips its
    own breaker on the injected clock and recovers at half-open."""
    x = np.zeros((2, 8), np.float32)
    with Fleet({"mlp": make_mlp()}, replicas=2,
               server_kwargs={"max_batch": 4}) as fleet:
        for _ in range(5):
            fleet.submit("mlp", x)
        scraper = aggregate.FleetScraper(fleet)
        snap = scraper.scrape()
        per = [snap["replicas"][n]["stats"]["completed"] for n in
               ("r0", "r1")]
        assert snap["fleet"]["completed"] == sum(per) == 5
        assert snap["scrape_ms"] >= 0 and snap["router"]["failovers"] == 0
        text = scraper.prometheus_text()
        parsed = aggregate.parse_prometheus_text(text)
        assert 'serving_completed{replica="r0"}' in text
        assert "serving_total_ms" in parsed
        sample = scraper.slo_sample(snap)
        assert sample["admitted"] == 5.0 and sample["bad"] == 0.0
        assert "+Inf" in sample["latency_buckets"]
    clock = _ticker(0.0)
    good, flaky = _FlakyReplica("r0"), _FlakyReplica("r1")
    scraper = aggregate.FleetScraper([good, flaky], clock=clock,
                                     breaker_failures=2,
                                     breaker_reset_s=60.0)
    assert scraper.scrape()["replicas"]["r1"]["ready"]
    flaky.failing = True
    assert "ConnectionError" in scraper.scrape()["replicas"]["r1"]["error"]
    assert scraper.scrape()["replicas"]["r1"]["breaker"] == "open"
    assert scraper.scrape()["replicas"]["r1"]["error"] == "circuit_open"
    flaky.failing = False
    clock.advance(61.0)
    one = scraper.scrape()["replicas"]["r1"]
    assert one["ready"] and "error" not in one
    assert 'fleet_replica_ready{replica="r1"} 1' in scraper.prometheus_text()
