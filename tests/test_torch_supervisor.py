"""The port's supervisor state machine and ProcessSpawner against the JAX
package's, on the same scripts.

Every script drives :meth:`Supervisor.poll_once` by hand under a virtual
clock with fake spawners, handles and a fake router (the pattern of
``tests/test_supervisor.py``): no process is forked here. Each script runs
once against ``mmlspark_tpu.serve.supervisor`` and once against
``mmlspark_tpu_torch.serve.supervisor``; the two runs must give equal
observations (``stats()`` snapshots, router traces, handle states) and
equal ``supervisor.*`` event sequences (timestamps aside). The scripts also
assert the reference tests' key properties, so a change shared by both
packages cannot pass unnoticed.
"""
import json
import os
import types

import pytest

from mmlspark_tpu.observability import events as jevents
from mmlspark_tpu.serve import fleet as jfleet
from mmlspark_tpu.serve import supervisor as jsup
from mmlspark_tpu.utils import config as jconfig
from mmlspark_tpu_torch.observability import events as tevents
from mmlspark_tpu_torch.serve import fleet as tfleet
from mmlspark_tpu_torch.serve import supervisor as tsup
from mmlspark_tpu_torch.utils import config as tconfig

JAX = types.SimpleNamespace(sup=jsup, fleet=jfleet, config=jconfig,
                            events=jevents, name="jax")
TORCH = types.SimpleNamespace(sup=tsup, fleet=tfleet, config=tconfig,
                              events=tevents, name="torch")


class VClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += float(s)


class FakeHandle:
    """A worker handle whose death the script decides."""

    def __init__(self, pid, addr):
        self.pid = pid
        self.addr = addr
        self.rc = None
        self.terminated = False
        self.killed = False
        self.closed = False

    def await_announce(self, timeout):
        return bool(self.addr)

    def poll(self):
        return self.rc

    def terminate(self):
        self.terminated = True
        if self.rc is None:
            self.rc = 0          # graceful drain: exits clean

    def kill(self):
        self.killed = True
        if self.rc is None:
            self.rc = -9

    def wait(self, timeout=None):
        return self.rc

    def close(self):
        self.closed = True

    def die(self, rc=1):
        self.rc = rc

    def state(self):
        return (self.pid, self.rc, self.terminated, self.killed, self.closed)


class FakeSpawner:
    def __init__(self):
        self.count = 0
        self.handles = {}

    def spawn(self, name):
        self.count += 1
        h = FakeHandle(1000 + self.count, f"127.0.0.1:{9000 + self.count}")
        self.handles.setdefault(name, []).append(h)
        return h

    def states(self):
        return {n: [h.state() for h in hs] for n, hs in self.handles.items()}


class DeadSpawner(FakeSpawner):
    """Every child is dead at birth: the crash-loop stimulus."""

    def spawn(self, name):
        h = super().spawn(name)
        h.addr = ""
        h.rc = 1
        return h


class WedgedHandle(FakeHandle):
    def terminate(self):
        self.terminated = True           # ignores SIGTERM

    def wait(self, timeout=None):
        return self.rc                   # None while alive


class WedgedSpawner(FakeSpawner):
    def spawn(self, name):
        self.count += 1
        h = WedgedHandle(3000 + self.count, "127.0.0.1:9100")
        self.handles.setdefault(name, []).append(h)
        return h


class DieFirstSpawner(FakeSpawner):
    def spawn(self, name):
        h = super().spawn(name)
        if name == "w0" and len(self.handles["w0"]) == 1:
            h.rc = 1                     # dead before /readyz
        return h


class FakeRouter:
    """The real Router's registration semantics: set_weight on an unknown
    name raises KeyError, removing the last replica ValueError."""

    def __init__(self, names):
        self.weights = {n: 1.0 for n in names}
        self.resets = []
        self.probes = 0
        self.added = []
        self.removed = []
        self.weight_trace = []

    def add_replica(self, rep, weight=1.0):
        if rep.name in self.weights:
            raise ValueError(f"duplicate replica {rep.name}")
        self.weights[rep.name] = float(weight)
        self.added.append((rep.name, float(weight)))

    def remove_replica(self, name):
        if name not in self.weights:
            raise KeyError(name)
        if len(self.weights) == 1:
            raise ValueError("cannot remove the last replica")
        del self.weights[name]
        self.removed.append(name)

    def set_weight(self, name, w):
        if name not in self.weights:
            raise KeyError(name)
        self.weights[name] = float(w)
        self.weight_trace.append((name, float(w)))

    def reset_breaker(self, name):
        self.resets.append(name)

    def probe(self):
        self.probes += 1
        return {}

    def stats(self):
        return {"replicas": {n: {"weight": w}
                             for n, w in self.weights.items()}}

    def trace(self):
        return {"weights": dict(self.weights), "resets": list(self.resets),
                "probes": self.probes, "added": list(self.added),
                "removed": list(self.removed),
                "weight_trace": list(self.weight_trace)}


def make_sup(pkg, spawner, names, clock, **kw):
    kw.setdefault("min_uptime_s", 1.0)
    kw.setdefault("base_delay_s", 2.0)
    kw.setdefault("max_delay_s", 8.0)
    kw.setdefault("ready_timeout_s", 5.0)
    kw.setdefault("breaker_failures", 3)
    kw.setdefault("breaker_reset_s", 60.0)
    kw.setdefault("ready_fn", lambda replica, handle: True)
    return pkg.sup.Supervisor(spawner, names, clock=clock,
                              sleep=lambda s: clock.advance(s), **kw)


# -- the scripts ---------------------------------------------------------------
# each takes a package namespace and returns what it observed

def s_start_registers_addrs(pkg):
    clock, sp = VClock(), FakeSpawner()
    sup = make_sup(pkg, sp, ["a", "b"], clock)
    sup.start()
    full = sup.stats()
    assert full["desired_replicas"] == 2 and full["live_replicas"] == 2
    assert sup.replica("a").addr == "http://127.0.0.1:9001"
    return {"stats": full, "pids": [sup.pid("a"), sup.pid("b")],
            "addrs": [r.addr for r in sup.replicas], "handles": sp.states()}


def s_crash_backoff_restart(pkg):
    clock, sp = VClock(), FakeSpawner()
    sup = make_sup(pkg, sp, ["a"], clock)
    router = FakeRouter(["a"])
    sup.attach_router(router)
    sup.start()
    obs = []
    clock.advance(1.5)
    sup.poll_once()                          # confirmed: min uptime
    obs.append(sup.stats())
    sp.handles["a"][0].die(3)
    sup.poll_once()                          # out of rotation, backoff
    assert router.weights["a"] == 0.0
    obs.append(sup.stats())
    sup.poll_once()                          # before the backoff expires
    obs.append(sup.stats())
    clock.advance(2.0)
    sup.poll_once()                          # restart, re-register
    st = sup.stats()["replicas"]["a"]
    assert st["running"] and st["spawns"] == 2
    assert router.weights["a"] == 1.0
    assert sup.replica("a").addr == "http://127.0.0.1:9002"
    obs.append(sup.stats())
    return {"stats": obs, "router": router.trace(), "handles": sp.states()}


def s_uptime_resets_crash_streak(pkg):
    clock, sp = VClock(), FakeSpawner()
    sup = make_sup(pkg, sp, ["a"], clock)
    sup.start()
    obs = []
    for delay in (2.0, 4.0):
        sp.handles["a"][-1].die(1)
        sup.poll_once()
        clock.advance(delay)
        sup.poll_once()
        obs.append(sup.stats())
    assert sup.stats()["replicas"]["a"]["consecutive_crashes"] == 2
    clock.advance(1.5)
    sup.poll_once()
    assert sup.stats()["replicas"]["a"]["consecutive_crashes"] == 0
    obs.append(sup.stats())
    sp.handles["a"][-1].die(1)
    sup.poll_once()
    clock.advance(1.9)
    sup.poll_once()
    obs.append(sup.stats())                  # 2.0 s not yet elapsed
    clock.advance(0.1)
    sup.poll_once()
    obs.append(sup.stats())
    return {"stats": obs, "handles": sp.states()}


def s_crash_loop_breaker_half_open(pkg):
    clock, sp = VClock(), DeadSpawner()
    sup = make_sup(pkg, sp, ["a"], clock, ready_fn=lambda r, h: False)
    sup.start()
    trace, opened_at = [], None
    for _ in range(200):
        sup.poll_once()
        state = sup.breaker_state("a")
        trace.append((clock.t, sp.count, state))
        if opened_at is None and state == "open":
            opened_at = clock.t
        clock.advance(1.0)
        if opened_at is not None and clock.t > opened_at + 75.0:
            break
    assert opened_at is not None
    assert sp.count == 4                     # 3 to trip + ONE probe
    assert sup.breaker_state("a") == "open"
    return {"trace": trace, "stats": sup.stats(), "count": sp.count}


def s_shutdown_drains(pkg):
    clock, sp = VClock(), FakeSpawner()
    sup = make_sup(pkg, sp, ["a", "b"], clock)
    sup.start()
    sup.shutdown(reason="test")
    sup.poll_once()                          # closed: no respawn
    sup.shutdown()                           # idempotent
    assert sp.count == 2
    assert all(h.terminated for hs in sp.handles.values() for h in hs)
    return {"stats": sup.stats(), "handles": sp.states()}


def s_shutdown_kills_straggler(pkg):
    clock, sp = VClock(), WedgedSpawner()
    sup = make_sup(pkg, sp, ["a"], clock)
    sup.start()
    sup.shutdown(drain_timeout_s=0.0)
    h = sp.handles["a"][0]
    assert h.terminated and h.killed
    return {"stats": sup.stats(), "handles": sp.states()}


def s_kill_replica_idempotent(pkg):
    clock, sp = VClock(), FakeSpawner()
    sup = make_sup(pkg, sp, ["a"], clock)
    sup.start()
    kills = [sup.kill_replica("a"), sup.kill_replica("a")]
    sup.poll_once()
    clock.advance(2.0)
    sup.poll_once()
    kills.append(sup.kill_replica("a"))
    assert kills == [1001, None, 1002]
    return {"kills": kills, "stats": sup.stats(), "handles": sp.states()}


def s_add_slot(pkg):
    clock, sp = VClock(), FakeSpawner()
    sup = make_sup(pkg, sp, ["a"], clock)
    router = FakeRouter(["a"])
    sup.attach_router(router)
    sup.start()
    name = sup.add_slot()
    assert name == "w0" and router.added == [("w0", 0.0)]
    assert router.weights["w0"] == 1.0       # lifted by the ready step
    with pytest.raises(ValueError):
        sup.add_slot(name="a")
    second = sup.add_slot()
    return {"names": [name, second], "stats": sup.stats(),
            "router": router.trace(), "handles": sp.states()}


def s_add_slot_dead_spawn_reconciles(pkg):
    clock, sp = VClock(), DieFirstSpawner()
    sup = make_sup(pkg, sp, ["a"], clock)
    router = FakeRouter(["a"])
    sup.attach_router(router)
    sup.start()
    name = sup.add_slot()
    obs = [sup.stats()]
    assert router.weights["w0"] == 0.0       # never lifted
    sup.poll_once()
    obs.append(sup.stats())
    clock.advance(2.0)
    sup.poll_once()
    obs.append(sup.stats())
    assert router.weights["w0"] == 1.0
    return {"name": name, "stats": obs, "router": router.trace(),
            "handles": sp.states()}


def s_retire_slot_drain_order(pkg):
    clock, sp = VClock(), FakeSpawner()
    sup = make_sup(pkg, sp, ["a", "b"], clock)
    router = FakeRouter(["a", "b"])
    sup.attach_router(router)
    sup.start()
    h = sp.handles["b"][0]
    at_terminate = {}
    orig = h.terminate

    def spy():
        at_terminate["b"] = router.weights["b"]
        orig()

    h.terminate = spy
    assert sup.retire_slot("b") is True
    assert at_terminate == {"b": 0.0}        # drained AFTER weight 0
    assert router.removed == ["b"] and "b" not in sup.breakers
    return {"stats": sup.stats(), "router": router.trace(),
            "at_terminate": at_terminate, "handles": sp.states(),
            "replicas": [r.name for r in sup.replicas]}


def s_retire_slot_idempotent(pkg):
    clock = VClock()
    sup = make_sup(pkg, FakeSpawner(), ["a", "b"], clock)
    sup.attach_router(FakeRouter(["a", "b"]))
    sup.start()
    got = [sup.retire_slot("nope"), sup.retire_slot("b"),
           sup.retire_slot("b")]
    assert got == [False, True, False]
    return {"got": got, "stats": sup.stats()}


def s_retire_last_replica(pkg):
    clock = VClock()
    sup = make_sup(pkg, FakeSpawner(), ["a"], clock)
    router = FakeRouter(["a"])
    sup.attach_router(router)
    sup.start()
    assert sup.retire_slot("a") is True
    assert router.weights == {"a": 0.0}      # registered, weightless
    return {"stats": sup.stats(), "router": router.trace()}


def s_retire_straggler_sigkill(pkg):
    clock, sp = VClock(), FakeSpawner()
    sup = make_sup(pkg, sp, ["a", "b"], clock)
    sup.attach_router(FakeRouter(["a", "b"]))
    sup.start()
    h = sp.handles["b"][0]
    h.terminate = lambda: None               # ignores SIGTERM
    h.wait = lambda timeout=None: None if not h.killed else -9
    assert sup.retire_slot("b", drain_timeout_s=0.0) is True
    assert h.killed
    return {"stats": sup.stats(), "killed": h.killed}


def s_process_fleet_routes_scale(pkg):
    clock = VClock()
    sup = make_sup(pkg, FakeSpawner(), ["a"], clock)
    router = FakeRouter(["a"])
    fleet = pkg.fleet.ProcessFleet(sup, router)
    assert sup.router is router              # auto-attached
    sup.start()
    name = fleet.scale_up()
    stats = fleet.stats()
    fleet.scale_down(name)
    fleet.scale_down(name)                   # idempotent
    with pytest.raises(NotImplementedError):
        fleet.reshard("2x4")
    fleet.close()
    return {"name": name, "fleet_stats": stats, "stats": sup.stats(),
            "router": router.trace()}


SCRIPTS = {f.__name__[2:]: f for f in (
    s_start_registers_addrs, s_crash_backoff_restart,
    s_uptime_resets_crash_streak, s_crash_loop_breaker_half_open,
    s_shutdown_drains, s_shutdown_kills_straggler,
    s_kill_replica_idempotent, s_add_slot, s_add_slot_dead_spawn_reconciles,
    s_retire_slot_drain_order, s_retire_slot_idempotent,
    s_retire_last_replica, s_retire_straggler_sigkill,
    s_process_fleet_routes_scale)}


def _run(pkg, script, path):
    """``script`` against ``pkg`` with its event log at ``path``: the
    observation and the ``supervisor.*`` events (timestamps dropped)."""
    pkg.config.set("observability.events_path", str(path))
    try:
        obs = script(pkg)
    finally:
        pkg.config.unset("observability.events_path")
        pkg.events.close()
    evs = []
    if os.path.exists(path):
        for line in open(path, encoding="utf-8"):
            e = json.loads(line)
            if e["type"] == "supervisor":
                e.pop("ts")
                evs.append(e)
    return json.loads(json.dumps(obs, default=str)), evs


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_supervisor_script_matches_reference(name, tmp_path):
    want, want_events = _run(JAX, SCRIPTS[name], tmp_path / "jax.jsonl")
    got, got_events = _run(TORCH, SCRIPTS[name], tmp_path / "torch.jsonl")
    assert got == want
    assert got_events == want_events
    assert got_events                        # every script emits


def test_supervisor_names_validated():
    clock = VClock()
    for bad in ([], ["a", "a"]):
        with pytest.raises(ValueError):
            make_sup(TORCH, FakeSpawner(), bad, clock)


# -- ProcessSpawner (no process spawned) ---------------------------------------

def _spawners(**kw):
    return (jsup.ProcessSpawner(["m=mlp_tabular:{}"], **kw),
            tsup.ProcessSpawner(["m=mlp_tabular:{}"], **kw))


def test_process_spawner_argv_runs_the_port_cli(tmp_path):
    kw = dict(host="127.0.0.9", events_dir=str(tmp_path / "ev"),
              compile_cache_dir=str(tmp_path / "cache"),
              extra_args=["--max-batch", "4"])
    ref, port = _spawners(**kw)
    argv = port.build_argv("w0")
    assert argv[1:4] == ["-m", "mmlspark_tpu_torch.cli", "serve"]
    want = ref.build_argv("w0")
    assert want[1:4] == ["-m", "mmlspark_tpu.cli", "serve"]
    assert argv[4:] == want[4:]              # same flags, same order
    env = port.build_env()
    assert env["PYTHONUNBUFFERED"] == "1"
    assert env["MMLSPARK_TPU_TORCH_RUNTIME_COMPILE_CACHE_DIR"] == \
        os.path.abspath(str(tmp_path / "cache"))
    import mmlspark_tpu_torch
    root = os.path.dirname(os.path.dirname(
        os.path.abspath(mmlspark_tpu_torch.__file__)))
    assert env["PYTHONPATH"].split(os.pathsep)[0] == root
    with pytest.raises(ValueError):
        tsup.ProcessSpawner([])


@pytest.mark.parametrize("k", [0, 1, 2])
def test_process_spawner_device_env_equals_reference(k, tmp_path):
    ref, port = _spawners(events_dir=str(tmp_path / "ev"),
                          devices_per_worker=k)
    names = ["w0", "w1", "w2", "w0"]
    got = [port.device_env(n) for n in names]
    assert got == [ref.device_env(n) for n in names]
    assert [port.slot_of(n) for n in names] == [0, 1, 2, 0]
    if k == 0:
        assert got[0] == {} and "CUDA_VISIBLE_DEVICES" not in \
            port.build_env("w0")
    else:
        cards = [set(e["CUDA_VISIBLE_DEVICES"].split(",")) for e in got[:3]]
        assert all(len(c) == k for c in cards)
        assert not (cards[0] & cards[1] or cards[1] & cards[2]
                    or cards[0] & cards[2])   # disjoint slots
        assert port.build_env("w1")["CUDA_VISIBLE_DEVICES"] == \
            got[1]["CUDA_VISIBLE_DEVICES"]


def test_process_spawner_explicit_env_outranks_pinning(tmp_path):
    ref, port = _spawners(events_dir=str(tmp_path / "ev"),
                          devices_per_worker=1,
                          env={"CUDA_VISIBLE_DEVICES": "7"})
    assert port.build_env("w0")["CUDA_VISIBLE_DEVICES"] == "7"
    assert ref.build_env("w0")["CUDA_VISIBLE_DEVICES"] == "7"
