"""The port's watchdog monitor and preemption drain, on the CPU.

The watchdog runs the reference's detection script on an injected clock
in both packages (same stalls, same latch and re-arm, the stacks dumped
into the event log); the abort action requests preemption; a zero
timeout turns detection off; ``cli serve`` starts its monitor when
``reliability.stall_timeout_s`` > 0; and SIGTERM in the middle of
``ResilientTrainLoop.run_dataset`` drains a loadable checkpoint with its
input-pipeline sidecar, from which a rerun finishes bit-identical to an
uninterrupted run (the reference's ``tests/test_liveness.py`` scenario).
"""
import contextlib
import json
import os
import signal
import threading

import numpy as np
import pytest
import torch

from mmlspark_tpu.reliability import preemption as jpreemption
from mmlspark_tpu.reliability import watchdog as jwatchdog
from mmlspark_tpu_torch.data import FileSource
from mmlspark_tpu_torch.observability import events as tevents
from mmlspark_tpu_torch.observability import metrics as tmetrics
from mmlspark_tpu_torch.parallel.checkpoint import TrainCheckpointer
from mmlspark_tpu_torch.parallel.optim import adam
from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer
from mmlspark_tpu_torch.reliability import preemption
from mmlspark_tpu_torch.reliability import watchdog as twatchdog
from mmlspark_tpu_torch.reliability.resilient import ResilientTrainLoop
from mmlspark_tpu_torch.utils import config as tconfig

DIM = 8
TIME_LIMIT_S = 120
WATCHDOGS = {"jax": jwatchdog, "port": twatchdog}


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    """CPU runs, a clean preemption latch and heartbeat registry, and a
    time limit for each test."""
    def expire(signum, frame):
        raise TimeoutError(f"test ran past its {TIME_LIMIT_S} s limit")
    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TIME_LIMIT_S)
    monkeypatch.chdir(tmp_path)    # the reference's stall dumps a file here
    tconfig.set("runtime.device", "cpu")
    preemption.reset()
    jpreemption.reset()
    yield
    for wd in WATCHDOGS.values():
        for hb in wd.registered():
            hb.close()
        wd.set_clock(None)
    preemption.reset()
    jpreemption.reset()
    tconfig.unset("runtime.device")
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


@contextlib.contextmanager
def _event_log(path):
    tconfig.set("observability.events_path", str(path))
    try:
        yield path
    finally:
        tevents.close()
        tconfig.unset("observability.events_path")


def _read_events(path):
    return [json.loads(ln) for ln in path.read_text().splitlines()
            if ln.strip()]


# -- the watchdog -------------------------------------------------------------

def _detection_script(wd):
    """The reference's stall script on an injected clock: returns what
    each check pass fired."""
    clock = {"t": 0.0}
    wd.set_clock(lambda: clock["t"])
    hb = wd.register("unit.loop")
    dog = wd.Watchdog(stall_timeout_s=5.0, start=False)
    passes = []

    def check(t):
        clock["t"] = t
        passes.append([(s.name, round(s.stalled_s, 6), s.timeout_s, s.beats,
                        "--- thread" in s.stacks, "MainThread" in s.stacks)
                       for s in dog.check()])
    hb.beat()
    check(4.9)     # inside the budget
    check(5.1)     # the first pass past it
    check(50.0)    # latched: one event per hang
    hb.beat()      # a beat re-arms
    check(52.0)
    check(60.0)
    hb.close()
    dog.close()
    return passes


def test_watchdog_detects_a_stall_and_dumps_the_stacks(tmp_path):
    tmetrics.get_registry().reset()
    want = _detection_script(jwatchdog)
    with _event_log(tmp_path / "events.jsonl") as path:
        got = _detection_script(twatchdog)
    assert got == want
    assert [len(p) for p in got] == [0, 1, 0, 0, 1]
    assert got[1][0][:3] == ("unit.loop", 5.1, 5.0)
    assert got[1][0][4:] == (True, True)
    stalls = [e for e in _read_events(path)
              if e.get("name") == "watchdog.stall"]
    assert len(stalls) == 2 and stalls[0]["heartbeat"] == "unit.loop"
    assert "--- thread" in stalls[0]["stacks"]
    assert tmetrics.counter("reliability.watchdog_stalls").value == 2


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_abort_requests_preemption_and_zero_timeout_disables(pkg):
    wd = WATCHDOGS[pkg]
    clock = {"t": 0.0}
    wd.set_clock(lambda: clock["t"])
    hb = wd.register("wedged.stage")
    off = wd.Watchdog(stall_timeout_s=0.0, start=False)
    clock["t"] = 1e9
    assert off.check() == []            # 0 turns detection off
    off.close()
    dog = wd.Watchdog(stall_timeout_s=1.0, action="abort", start=False)
    assert len(dog.check()) == 1
    latch = preemption if pkg == "port" else jpreemption
    assert latch.preempted()
    assert "watchdog stall" in latch.preemption_reason()
    hb.close()
    dog.close()
    with pytest.raises(ValueError, match="action"):
        wd.Watchdog(action="explode", start=False)


def test_heartbeat_timeout_override_and_context_manager():
    clock = {"t": 0.0}
    twatchdog.set_clock(lambda: clock["t"])
    dog = twatchdog.Watchdog(stall_timeout_s=100.0, start=False)
    with twatchdog.register("fast.stage", timeout_s=0.5) as hb:
        clock["t"] = 1.0
        fired = dog.check()             # the heartbeat's own timeout wins
        assert [s.name for s in fired] == ["fast.stage"]
        assert fired[0].timeout_s == 0.5
        assert hb in twatchdog.registered()
    assert "fast.stage" not in [h.name for h in twatchdog.registered()]
    dog.close()


def test_monitor_thread_flags_a_real_stall_and_survives_a_broken_action():
    seen = []

    def action(stall):
        seen.append(stall.name)
        raise RuntimeError("a broken escalation must not kill the monitor")
    hb = twatchdog.register("really.stuck", timeout_s=0.05)
    dog = twatchdog.Watchdog(stall_timeout_s=10.0, action=action,
                             poll_s=0.02)
    try:
        for _ in range(200):
            if len(seen) >= 1:
                break
            threading.Event().wait(0.02)
        hb.beat()                       # re-arm, then stall again
        for _ in range(200):
            if len(seen) >= 2:
                break
            threading.Event().wait(0.02)
    finally:
        dog.close()
        hb.close()
    assert seen[:2] == ["really.stuck", "really.stuck"]
    assert dog._thread is None


def test_cli_serve_starts_its_watchdog_with_a_stall_timeout(monkeypatch,
                                                            capsys):
    """``cli serve`` with ``reliability.stall_timeout_s`` > 0 serves, runs
    a Watchdog over the process's heartbeats (a wedged one is flagged
    while the server runs), drains on preemption and closes the monitor."""
    from mmlspark_tpu_torch import cli
    dogs = []
    real = twatchdog.Watchdog

    class Recording(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            dogs.append(self)
    monkeypatch.setattr(twatchdog, "Watchdog", Recording)
    tconfig.set("reliability.stall_timeout_s", 5.0)
    tconfig.set("reliability.watchdog_poll_s", 0.02)
    wedged = twatchdog.register("wedged.stage", timeout_s=0.05)
    rc = {}
    t = threading.Thread(target=lambda: rc.setdefault("rc", cli.main(
        ["serve", "--port", "0", "--model",
         'm=mlp_tabular:{"input_dim": 4, "hidden": [8]}'])))
    try:
        t.start()
        for _ in range(500):
            if dogs and dogs[0].stalls:
                break
            threading.Event().wait(0.02)
        assert dogs and [s.name for s in dogs[0].stalls] == ["wedged.stage"]
        assert dogs[0]._thread is not None
        preemption.request_preemption("test drain")
        t.join(60.0)
        assert not t.is_alive() and rc["rc"] == 0
        assert dogs[0]._thread is None          # closed with the server
    finally:
        wedged.close()
        preemption.request_preemption("test cleanup")
        t.join(10.0)
        tconfig.unset("reliability.stall_timeout_s")
        tconfig.unset("reliability.watchdog_poll_s")
    announce = json.loads(capsys.readouterr().out.splitlines()[0])
    assert announce["models"] == ["m"] and announce["ready"] is True


# -- preemption: SIGTERM mid-run_dataset --------------------------------------

class Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.full((DIM, DIM), 0.1))
        self.b = torch.nn.Parameter(torch.zeros(DIM))

    def forward(self, x):
        return x @ self.w + self.b


def _trainer():
    def loss(module, batch, gen):
        return ((module(batch["x"]) - batch["y"]) ** 2).mean()
    return DistributedTrainer(loss, adam(1e-2))


def _vec_pipeline(root, kill_at_record=None):
    seen = {"n": 0}

    def parse(rec):
        seen["n"] += 1
        if kill_at_record is not None and seen["n"] == kill_at_record:
            os.kill(os.getpid(), signal.SIGTERM)   # the preemption notice
        x = np.frombuffer(rec["bytes"], np.float32)
        return {"x": x, "y": (x * 0.5).astype(np.float32)}
    return FileSource(str(root)).map(parse).batch(8, remainder="drop"
                                                  ).repeat()


def test_sigterm_mid_run_dataset_drains_checkpoint_and_sidecar_then_resumes(
        tmp_path):
    root = tmp_path / "vecs"
    root.mkdir()
    for i in range(32):
        rng = np.random.default_rng(i)
        (root / f"r_{i:03d}.bin").write_bytes(
            rng.normal(0, 1, (DIM,)).astype(np.float32).tobytes())
    total = 10
    ck_ref = TrainCheckpointer(str(tmp_path / "ref"))
    ref = ResilientTrainLoop(_trainer(), ck_ref, Linear,
                             save_every=3).run_dataset(_vec_pipeline(root),
                                                       total)
    ck_ref.close()
    assert preemption.install_handlers() is True
    ckdir = str(tmp_path / "preempted")
    try:
        with _event_log(tmp_path / "events.jsonl") as path:
            ck_a = TrainCheckpointer(ckdir)
            ResilientTrainLoop(_trainer(), ck_a, Linear,
                               save_every=3).run_dataset(
                _vec_pipeline(root, kill_at_record=36), total)
        assert preemption.preempted()
        step = ck_a.latest_step()
        assert step is not None and 0 < step < total and step % 3 != 0
        assert ck_a.get_data_state(step) is not None
        restored = ck_a.restore(_trainer(), Linear)
        assert int(restored["step"]) == step
        ck_a.close()
    finally:
        preemption.uninstall_handlers()
        preemption.reset()
    drains = [e for e in _read_events(path)
              if e.get("name") == "preemption.drain"]
    assert [(d["step"], d["kind"]) for d in drains] == [(step, "train")]
    ck_b = TrainCheckpointer(ckdir)
    resumed = ResilientTrainLoop(_trainer(), ck_b, Linear,
                                 save_every=3).run_dataset(
        _vec_pipeline(root), total)
    ck_b.close()
    for name in ("w", "b"):
        assert torch.equal(getattr(ref["module"], name),
                           getattr(resumed["module"], name))
    assert resumed["optimizer"].count == ref["optimizer"].count == total


def test_preempted_run_drains_with_an_event(tmp_path):
    calls = {"n": 0}

    def batch_fn(step):
        calls["n"] += 1
        if calls["n"] == 4:
            preemption.request_preemption("simulated eviction notice")
        rng = np.random.default_rng(step)
        x = rng.normal(0, 1, (16, DIM)).astype(np.float32)
        return {"x": x, "y": (x * 0.5).astype(np.float32)}
    ck = TrainCheckpointer(str(tmp_path / "ck"))
    with _event_log(tmp_path / "events.jsonl") as path:
        ResilientTrainLoop(_trainer(), ck, Linear,
                           save_every=10).run(batch_fn, 20)
    assert ck.latest_step() == 4
    ck.close()
    drains = [e for e in _read_events(path)
              if e.get("name") == "preemption.drain"]
    assert len(drains) == 1 and drains[0]["step"] == 4
    assert "eviction" in drains[0]["reason"]
