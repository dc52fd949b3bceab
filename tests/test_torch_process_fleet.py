"""The port's process fleet with real worker processes on the CPU.

Two ``python -m mmlspark_tpu_torch.cli serve`` workers (spawned by the
port's :class:`ProcessSpawner`, supervised by its :class:`Supervisor`, with
``MMLSPARK_TPU_TORCH_RUNTIME_DEVICE=cpu`` in their environment) serve a tiny
``mlp_tabular`` and ``transformer_lm_tiny`` behind the :class:`Router`:
scores and greedy tokens equal an in-process port ``Server`` of the same
spec; a SIGKILL of one worker (``kill_replica``) is followed by a restart
with a new pid, the same name and the same answers; ``ProcessFleet`` adds a
worker and retires it with a SIGTERM drain (rc 0), whose ``serving.summary``
event carries the worker's device report; after ``shutdown`` no child is
alive. The CLI's ``serve`` announce and SIGTERM drain, ``fleet``'s front
router (``/generate`` and ``/score`` through two workers, SIGTERM draining
both), the preemption latch and the launcher's host lists and argv are
checked on their own. Every wait
is bounded, and every child is killed in a ``finally``.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from mmlspark_tpu.serve import launcher as jlauncher
from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.reliability import preemption
from mmlspark_tpu_torch.serve import (
    ProcessFleet, ProcessSpawner, Router, Server, Supervisor,
)
from mmlspark_tpu_torch.serve import launcher
from mmlspark_tpu_torch.utils import config as tconfig

_LANE = {"generate.max_seq_len": 64, "generate.max_sequences": 4,
         "generate.kv_block_tokens": 8}
_MLP = {"input_dim": 4, "hidden": [8], "num_classes": 3, "seed": 7}
_MODELS = ["mlp=mlp_tabular:" + json.dumps(_MLP), "lm=transformer_lm_tiny"]
_ENV = {"MMLSPARK_TPU_TORCH_RUNTIME_DEVICE": "cpu",
        **{"MMLSPARK_TPU_TORCH_" + k.replace(".", "_").upper(): str(v)
           for k, v in _LANE.items()}}
_PROMPTS = [list(range(3, 3 + n)) for n in (5, 17, 30)]
_XS = [np.arange(4, dtype=np.float32) * (i + 1) - 3.0 for i in range(3)]


class RecordingSpawner(ProcessSpawner):
    """Keeps every worker it spawns, so the test can reap them all."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.workers = []

    def spawn(self, name):
        w = super().spawn(name)
        self.workers.append(w)
        return w


@pytest.fixture
def cpu_lane():
    tconfig.set("runtime.device", "cpu")
    for k, v in _LANE.items():
        tconfig.set(k, v)
    yield
    for k in tuple(_LANE) + ("runtime.device",):
        tconfig.unset(k)


def _reference():
    """Scores and greedy tokens from one in-process port Server."""
    lm = TorchModel(inputCol="x", outputCol="y").set_model(
        "transformer_lm_tiny")
    mlp = TorchModel(inputCol="x", outputCol="y").set_model(
        "mlp_tabular", **_MLP)
    srv = Server({"mlp": mlp, "lm": lm})
    try:
        scores = [np.asarray(srv.submit("mlp", x, timeout=30)) for x in _XS]
        tokens = [srv.generate("lm", p, max_new_tokens=6,
                               timeout=60)["tokens"] for p in _PROMPTS]
    finally:
        srv.close()
    return scores, tokens


def _answers(router):
    scores = [np.asarray(router.submit("mlp", x)) for x in _XS]
    tokens = [router.submit_generate("lm", p, 6)["tokens"] for p in _PROMPTS]
    return scores, tokens


def _same(got, want):
    return all(np.array_equal(a, b) for a, b in zip(got[0], want[0])) \
        and got[1] == want[1]


def _wait(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


def test_process_fleet_serves_restarts_and_drains_like_one_server(
        cpu_lane, tmp_path):
    want = _reference()
    events_dir = str(tmp_path / "ev")
    spawner = RecordingSpawner(_MODELS, events_dir=events_dir, env=_ENV)
    sup = Supervisor(spawner, ["w0", "w1"], min_uptime_s=0.5,
                     base_delay_s=0.1, max_delay_s=1.0, ready_timeout_s=60.0,
                     breaker_failures=3, breaker_reset_s=60.0)
    try:
        sup.start()
        router = Router(sup.replicas, failover_delay_s=0.0)
        fleet = ProcessFleet(sup, router)
        assert sup.router is router
        stats = sup.stats()
        assert stats["live_replicas"] == 2
        got = _answers(router)
        assert _same(got, want)

        # SIGKILL w1: the supervisor restarts it under the same name
        old = sup.pid("w1")
        assert sup.kill_replica("w1") == old
        sup.start_monitor(poll_s=0.05)
        _wait(lambda: sup.stats()["replicas"]["w1"]["ready_spawns"] == 2,
              60.0, "w1's restart")
        st = sup.stats()["replicas"]["w1"]
        assert st["running"] and sup.pid("w1") != old
        assert router.stats()["replicas"]["w1"]["weight"] == 1.0
        for _ in range(2):                   # both replicas answer alike
            assert _same(_answers(router), want)

        # ProcessFleet: one worker more, then a drained retire
        name = fleet.scale_up()
        assert name == "w2" and sup.stats()["live_replicas"] == 3
        w2 = spawner.workers[-1]
        assert _same(_answers(router), want)
        fleet.scale_down(name)
        assert w2.proc.returncode == 0       # drained through SIGTERM
        assert "w2" not in router.stats()["replicas"]
        summaries = []
        for line in open(os.path.join(events_dir,
                                      f"events-{w2.pid}.jsonl")):
            e = json.loads(line)
            if e["type"] == "serving" and e["name"] == "summary":
                summaries.append(e)
        (summary,) = summaries
        report = summary["device"]
        assert report["tf32_matmul"] is False
        assert report["memory_bytes"] == {}   # no CUDA here
        assert set(report["launches"]) >= {"flash_attention",
                                           "flash_attention_tc"}
        assert any(p["kind"] == "prefill" and p["replays"] > 0
                   for p in report["programs"])
        with pytest.raises(NotImplementedError):
            fleet.reshard("2x2")
        fleet.close()                        # shuts the supervisor down
        assert all(w.poll() is not None for w in spawner.workers)
        assert sup.stats()["live_replicas"] == 0
    finally:
        sup.shutdown(drain_timeout_s=10.0)
        for w in spawner.workers:
            if w.poll() is None:
                w.kill()
                w.wait(10.0)
    assert len(spawner.workers) == 4         # w0, w1, w1 again, w2
    assert all(w.poll() is not None for w in spawner.workers)


def test_cli_serve_announces_first_and_drains_on_sigterm(tmp_path):
    env = dict(os.environ, PYTHONUNBUFFERED="1", **_ENV)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "mmlspark_tpu_torch.cli", "serve",
         "--port", "0", "--model", "lm=transformer_lm_tiny",
         "--events-dir", str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env,
        text=True)
    try:
        first = {}

        def read():
            first["line"] = proc.stdout.readline()
        reader = threading.Thread(target=read, daemon=True)
        reader.start()
        reader.join(60.0)
        info = json.loads(first["line"])     # the FIRST line is the JSON
        assert info["models"] == ["lm"] and info["pid"] == proc.pid
        assert info["ready"] is True
        from mmlspark_tpu_torch.serve import HttpReplica
        rep = HttpReplica(info["serving"])
        out = rep.submit_generate("lm", _PROMPTS[0], 4)
        assert len(out["tokens"]) == 4
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60.0) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10.0)
    names = [(e["type"], e["name"]) for e in map(
        json.loads, open(tmp_path / f"events-{proc.pid}.jsonl"))]
    assert ("event", "preemption.signal") in names
    assert ("event", "preemption.drain") in names
    assert ("serving", "summary") in names


def test_cli_fleet_routes_generate_and_drains_every_worker(tmp_path):
    """``cli fleet``: two workers behind the front router's HTTP
    ``/generate`` and ``/score``; SIGTERM drains every child, rc 0."""
    env = dict(os.environ, PYTHONUNBUFFERED="1", **_ENV)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "mmlspark_tpu_torch.cli", "fleet",
         "--port", "0", "--replicas", "2", "--events-dir", str(tmp_path),
         *sum((["--model", m] for m in _MODELS), [])],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env,
        text=True)
    try:
        first = {}
        reader = threading.Thread(
            target=lambda: first.setdefault("line", proc.stdout.readline()),
            daemon=True)
        reader.start()
        reader.join(120.0)
        info = json.loads(first["line"])
        assert info["replicas"] == 2 and info["ready"] is True
        workers = [r["pid"] for r in info["workers"]["replicas"].values()]
        assert len(workers) == 2
        from mmlspark_tpu_torch.serve import HttpReplica
        front = HttpReplica(info["serving"])
        scores, tokens = _reference_on_cpu()
        got = [front.submit_generate("lm", p, 6)["tokens"] for p in _PROMPTS]
        assert got == tokens
        np.testing.assert_array_equal(front.submit("mlp", _XS[0]),
                                      scores[0])
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60.0) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10.0)
    for pid in workers:                      # every child drained and gone
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    names = [(e["type"], e["name"]) for e in map(
        json.loads, open(tmp_path / f"events-{proc.pid}.jsonl"))]
    assert ("supervisor", "shutdown") in names


def _reference_on_cpu():
    tconfig.set("runtime.device", "cpu")
    for k, v in _LANE.items():
        tconfig.set(k, v)
    try:
        return _reference()
    finally:
        for k in tuple(_LANE) + ("runtime.device",):
            tconfig.unset(k)


def test_cli_serve_refuses_the_unported_watchdog(monkeypatch):
    """The watchdog's monitor is ported now (the name is kept from when
    ``cli serve`` refused a stall timeout): with one set, ``serve`` no
    longer exits at the watchdog and goes on to build its server, which
    here, with ``runtime.device`` at its default and no card, raises the
    port's no-CUDA error instead of running on the CPU."""
    import torch
    from mmlspark_tpu_torch import cli
    if torch.cuda.is_available():
        pytest.skip("the check is for a machine without CUDA")
    monkeypatch.delenv("MMLSPARK_TPU_TORCH_RUNTIME_DEVICE", raising=False)
    tconfig.set("reliability.stall_timeout_s", 1.0)
    try:
        with pytest.raises(RuntimeError, match="is_available"):
            cli.main(["serve", "--model",
                      'm=mlp_tabular:{"input_dim": 4}'])
    finally:
        tconfig.unset("reliability.stall_timeout_s")


def test_preemption_latch_and_main_thread_handlers():
    preemption.reset()
    try:
        assert not preemption.preempted()
        preemption.request_preemption("test")
        preemption.request_preemption("again")
        assert preemption.preempted()
        assert preemption.preemption_reason() == "test"   # first wins
        assert preemption.get_signal().wait(0.0)
        result = {}
        t = threading.Thread(
            target=lambda: result.setdefault(
                "ok", preemption.install_handlers()))
        t.start()
        t.join()
        assert result["ok"] is False          # off the main thread
        prev = signal.getsignal(signal.SIGTERM)
        assert preemption.install_handlers() is True
        assert signal.getsignal(signal.SIGTERM) is preemption._handler
        preemption.uninstall_handlers()
        assert signal.getsignal(signal.SIGTERM) is prev
    finally:
        preemption.reset()


def test_launcher_hosts_and_argv_equal_the_reference(tmp_path):
    for spec in ("", "local", "h1, h2,,h3", " a ,b"):
        assert launcher.parse_hosts(spec) == jlauncher.parse_hosts(spec)
    for mod in (launcher, jlauncher):
        with pytest.raises(ValueError):
            mod.parse_hosts("h1,h2,h1")    # two supervisors on one host
    hosts = tmp_path / "hosts"
    hosts.write_text("# fleet\nlocal\n\nnode-2  # spare\nnode-3\n")
    assert launcher.read_hosts_file(str(hosts)) == \
        jlauncher.read_hosts_file(str(hosts))
    kw = dict(replicas_per_host=2, events_dir=str(tmp_path / "ev"),
              extra_args=["--devices-per-worker", "0"])
    port = launcher.HostLauncher(["local", "node-2"], _MODELS, **kw)
    ref = jlauncher.HostLauncher(["local", "node-2"], _MODELS, **kw)
    argv = port.build_argv("node-2")
    assert argv[1:4] == ["-m", "mmlspark_tpu_torch.cli", "fleet"]
    assert argv[4:] == ref.build_argv("node-2")[4:]
    assert port.host_events_dir("node-2") == ref.host_events_dir("node-2")
    assert launcher.LocalExec().wrap(argv) == argv
    assert launcher.SshExec("node-2").wrap(["a b", "c"]) == \
        jlauncher.SshExec("node-2").wrap(["a b", "c"])
