"""The run's record in the port against the JAX package's, on the CPU:
spans and their sink, the flight recorder, trace export, run reports,
the profiling hooks, and the CLI's ``report`` and ``launch-pod``.

Reports and traces are pure data, so the two packages' outputs are held
EQUAL (``==``) on the same events log: a fixture that fills every report
section, and a log the port itself wrote.
"""
import json
import logging
import os

import numpy as np
import pytest

from mmlspark_tpu.observability import flightrec as jflightrec
from mmlspark_tpu.observability import report as jreport
from mmlspark_tpu.observability import spans as jspans
from mmlspark_tpu.observability import trace as jtrace
from mmlspark_tpu.utils import config as jconfig
from mmlspark_tpu_torch import cli
from mmlspark_tpu_torch.observability import events, flightrec, report
from mmlspark_tpu_torch.observability import spans, syncs, trace
from mmlspark_tpu_torch.reliability import watchdog
from mmlspark_tpu_torch.utils import config as tconfig
from mmlspark_tpu_torch.utils import profiling

SECTIONS = {"stages", "slowest", "reliability", "liveness", "syncs",
            "serving", "workload", "generate", "fleet", "affinity",
            "supervisor", "slo", "autopilot", "memory", "compile_cache",
            "throughput", "input_pipeline", "bench"}


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)     # default flight-recorder dumps land here
    tconfig.set("runtime.device", "cpu")
    flightrec.clear()
    jflightrec.clear()
    yield
    for key in ("runtime.device", "observability.events_path",
                "observability.flight_recorder_size",
                "observability.annotate", "profiling.trace_dir"):
        tconfig.unset(key)
    events.close()
    events.reset_clock()
    flightrec.clear()
    jflightrec.clear()
    watchdog.set_clock(None)


def _fixture_events():
    """One event of every kind each report section reads (the reference's
    names and fields), two processes' spans among them."""
    t = 1_700_000_000.0
    out = []

    def ev(etype, name, dt, **fields):
        out.append({"ts": round(t + dt, 6), "type": etype, "name": name,
                    **fields})

    for pid in (11, 12):
        ev("span", "fit:Deep", 0.0, span_id=1, pid=pid, parent_id=None,
           parent="", depth=0, start=t, dur_s=2.5)
        ev("span", "train:step", 0.1, span_id=2, pid=pid, parent_id=1,
           parent="fit:Deep", depth=1, start=t + 0.1, dur_s=0.4,
           attrs={"step": 1})
        ev("span", "train:step", 0.6, span_id=3, pid=pid, parent_id=1,
           parent="fit:Deep", depth=1, start=t + 0.6, dur_s=0.5,
           error="RuntimeError")
        ev("span", "checkpoint:save", 1.2, span_id=4, pid=pid, parent_id=3,
           parent="train:step", depth=2, start=t + 0.7, dur_s=0.2)
    ev("event", "retry.attempt", 0.2, policy="http", attempt=1,
       delay_s=0.1, error="TimeoutError")
    ev("event", "fault.hit", 0.3, site="checkpoint.save", kind="raise")
    ev("event", "checkpoint.quarantine", 0.4, step=5, reason="torn")
    ev("event", "watchdog.stall", 0.5, heartbeat="train.loop",
       stalled_s=12.5, timeout_s=10.0, beats=3, stacks="--- thread")
    ev("event", "breaker.open", 0.6, breaker="lane", failures=5)
    ev("event", "breaker.close", 0.7, breaker="lane")
    ev("event", "preemption.signal", 0.8, reason="SIGTERM")
    ev("event", "preemption.drain", 0.9, step=7, reason="SIGTERM",
       kind="train")
    ev("event", "checkpoint.data_state_quarantine", 1.0, path="x.json",
       why="sha256 mismatch")
    ev("event", "flightrec.dump", 1.1, reason="crash", events=9,
       dropped=0, capacity=256, pid=11)
    for i, site in enumerate(["trainer.flush", "trainer.flush",
                              "deep.validation"]):
        ev("event", "sync.point", 1.2 + i / 10, site=site,
           kind="device_get", span="train:step" if i else None,
           span_id=2 if i else None)
    ev("event", "train.fit", 1.6, steps=4, rows=256, wall_s=2.0,
       examples_per_s=128.0, tflops_per_s=0.5, mfu=0.01)
    ev("metric", "train.step", 1.7, step=4, loss=0.5,
       examples_per_sec=130.0)
    ev("event", "data.epoch", 1.8, epoch=0, items=64, wall_s=0.5)
    ev("event", "bench.config", 1.9, config="deep", value=1.0)
    for i in range(3):
        ev("serving", "request", 2.0 + i / 10, model="m", rows=4,
           total_ms=10.0 + i, queue_ms=1.0, pad_ms=0.5, compute_ms=8.0,
           occupancy=0.75, trace_id=f"t{i}", slow=i == 2)
    ev("serving", "shed", 2.3, model="m", reason="queue_full")
    ev("serving", "expired", 2.4, model="m")
    ev("workload", "summary", 2.5, lane="m", offered=10, delivered=8,
       offered_qps=5.0, delivered_qps=4.0, goodput=0.7, shed=1,
       expired=1, deadline_ms=50.0, arrival_p50_ms=10.0,
       arrival_p99_ms=40.0,
       worst_bucket={"t0": 1.0, "p99_ms": 45.0, "trace_id": "t2"})
    ev("generate", "request", 2.6, model="lm", ttft_ms=20.0, itl_ms=5.0,
       prompt_tokens=40, new_tokens=8, trace_id="g1", spec_proposed=6,
       spec_accepted=4)
    ev("generate", "shed", 2.7, model="lm")
    ev("generate", "expired", 2.8, model="lm")
    ev("fleet", "failover", 2.9, replica="r0", kind="generate")
    ev("decode", "step", 3.0, rows=4, blocks_used=10, blocks_total=64,
       step_ms=2.0)
    ev("decode", "prefix", 3.1, hit_tokens=32, prompt_tokens=40)
    ev("decode", "cow", 3.2, copies=1)
    ev("decode", "arena", 3.3, dtype="int8", bytes=1024, fp_bytes=4096)
    ev("fleet", "failover", 3.4, replica="r1")
    ev("fleet", "all_shed", 3.5)
    ev("fleet", "tenant_throttled", 3.6, tenant="a")
    ev("fleet", "replica_killed", 3.7, replica="r1")
    for name in ("shift", "warm", "done"):
        ev("rollout", name, 3.8, target="m@v2", replica="r0")
    ev("affinity", "route", 3.9, mode="affinity", replica="r0",
       hit_depth=2)
    ev("affinity", "advertise", 4.0, replica="r0", blocks=5)
    for name in ("spawn", "restart", "backoff", "giveup", "exit",
                 "add_slot", "retire", "retire_noop", "ready", "shutdown"):
        ev("supervisor", name, 4.1, slot=0, pid=99, rc=1, delay_s=0.5,
           ready_s=1.5)
    ev("slo", "burn", 4.2, objective="ttft", window="fast", rate=14.0)
    ev("slo", "breach", 4.3, objective="ttft", window="slow", rate=2.0)
    ev("autopilot", "scale_up", 4.4, target="m", reason="queue deep",
       t=4.4, suppressed=False)
    ev("autopilot", "scale_down", 4.5, target="m", reason="idle", t=4.5,
       suppressed=True)
    ev("memory", "pressure", 4.6, total_bytes=1 << 30,
       budget_bytes=1 << 31, share=0.5)
    ev("memory", "audit", 4.7, total_bytes=1 << 30, live_bytes=1 << 29,
       untracked_bytes=0)
    for name in ("hit", "miss", "stale", "store", "bypass", "quarantine"):
        ev("compile_cache", name, 4.8, key="k", model="m")
    return out


def _write(path, evs):
    with open(path, "w") as f:
        for e in evs:
            f.write(json.dumps(e, sort_keys=True) + "\n")
    return str(path)


def _same_outputs(path):
    """Both packages' report (dict and text) and trace of one log."""
    got, want = report.build_report(path), jreport.build_report(path)
    assert got == want
    assert report.render_report(path) == jreport.render_report(path)
    evs = report.load_events(path)
    t_got, t_want = trace.build_trace(evs), jtrace.build_trace(evs)
    assert t_got == t_want
    assert trace.validate_trace(t_got) == jtrace.validate_trace(t_want) == []
    return got


def test_report_and_trace_equal_the_reference_on_a_full_fixture(tmp_path):
    """Every report section (all 18) renders from a log that has their
    events, and the structured report, its text, the Chrome trace and its
    validation all equal the JAX package's on it."""
    path = _write(tmp_path / "events.jsonl", _fixture_events())
    got = _same_outputs(path)
    assert SECTIONS <= set(got), SECTIONS - set(got)


def test_report_and_trace_equal_the_reference_on_a_port_log(tmp_path):
    """A log the port wrote itself (nested spans, an error span, sync
    points, a checkpointed DeepClassifier fit and a watchdog stall)
    renders the same through both packages."""
    from mmlspark_tpu_torch.core.frame import Frame
    from mmlspark_tpu_torch.train.deep import DeepClassifier
    path = str(tmp_path / "port.jsonl")
    tconfig.set("observability.events_path", path)
    with spans.span("fit", "Outer", rows=8):
        with spans.span("step"):
            syncs.sync_point("unit.site", "device_get")
        with pytest.raises(KeyError):
            with spans.span("step", "bad"):
                raise KeyError("x")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 4)).astype(np.float32)
    DeepClassifier(featuresCol="features", labelCol="label",
                   architecture="mlp_tabular",
                   architectureArgs={"hidden": [4]}, batchSize=16,
                   epochs=1, checkpointDir=str(tmp_path / "ck"),
                   checkpointEvery=1).fit(
        Frame.from_dict({"features": x, "label": (x[:, 0] > 0).astype(int)}))
    clock = [0.0]
    watchdog.set_clock(lambda: clock[0])
    hb = watchdog.register("unit.loop", timeout_s=1.0)
    clock[0] = 5.0
    watchdog.Watchdog(stall_timeout_s=1.0, start=False).check()
    hb.close()
    events.close()
    got = _same_outputs(path)
    assert {"stages", "slowest", "syncs", "liveness"} <= set(got)
    assert got["liveness"]["stalls"]["total"] == 1


def test_span_events_carry_the_reference_schema(tmp_path):
    """A span's event has the reference's fields (span_id, pid, parent_id,
    parent, depth, start, dur_s, and error / attrs where present), and
    :func:`current_span` returns ``(name, span_id)`` as the reference's
    does. The port's earlier ``current_span`` returned the bare name
    ("fit:Outer" where the reference gives ("fit:Outer", id)), and its
    spans emitted nothing."""
    path = str(tmp_path / "e.jsonl")
    tconfig.set("observability.events_path", path)
    jconfig.set("observability.events_path", str(tmp_path / "j.jsonl"))
    try:
        with spans.span("fit", "Outer", rows=3) as outer:
            got = spans.current_span()
            with spans.span("step"):
                inner = spans.current_span()
        with jspans.span("fit", "Outer", rows=3):
            want = jspans.current_span()
    finally:
        jconfig.unset("observability.events_path")
    assert spans.current_span() is None
    assert got == ("fit:Outer", outer.span_id) and got != "fit:Outer"
    assert type(got) is type(want) and got[0] == want[0]
    assert inner[0] == "step" and inner[1] != outer.span_id
    events.close()
    lines = [json.loads(l) for l in open(path)]
    step, fit = lines
    assert set(fit) == {"ts", "type", "name", "span_id", "pid", "parent_id",
                        "parent", "depth", "start", "dur_s", "attrs"}
    assert fit["attrs"] == {"rows": 3} and fit["parent_id"] is None
    assert (step["parent_id"], step["parent"], step["depth"]) == \
        (fit["span_id"], "fit:Outer", 1)
    assert step["pid"] == os.getpid() and step["dur_s"] <= fit["dur_s"]


def test_noop_span_only_when_every_sink_is_off():
    """With the events path unset, the ring keeps spans (the flight
    recorder is on by default); with the ring off too, ``span`` is the
    shared no-op."""
    with spans.span("a"):
        pass
    assert [e["name"] for e in flightrec.snapshot()] == ["a"]
    tconfig.set("observability.flight_recorder_size", 0)
    assert spans.span("b") is spans._NOOP
    assert not events.recording_enabled()


def _fill(mod_events, n):
    for i in range(n):
        mod_events.emit("event", "unit.e", i=i)


def test_flight_recorder_ring_matches_the_reference(tmp_path):
    """The same emits through both packages' event logs: the same ring
    contents (bounded at the configured size, newest kept), the same dump
    header (the reason, events, dropped, capacity), and size 0 turns the
    recorder off."""
    from mmlspark_tpu.observability import events as jevents
    tconfig.set("observability.flight_recorder_size", 8)
    jconfig.set("observability.flight_recorder_size", 8)
    try:
        _fill(events, 20)
        _fill(jevents, 20)
        strip = lambda evs: [{k: v for k, v in e.items() if k != "ts"}
                             for e in evs]
        assert strip(flightrec.snapshot()) == strip(jflightrec.snapshot())
        assert [e["i"] for e in flightrec.snapshot()] == list(range(12, 20))
        got = flightrec.dump("unit", str(tmp_path / "t.jsonl"))
        want = jflightrec.dump("unit", str(tmp_path / "j.jsonl"))
        heads = [json.loads(open(p).readline()) for p in (got, want)]
        for h in heads:
            h.pop("ts")
        assert heads[0] == heads[1]
        assert heads[0] == {"type": "event", "name": "flightrec.dump",
                            "reason": "unit", "events": 8, "dropped": 12,
                            "capacity": 8, "pid": os.getpid()}
        assert len(open(got).readlines()) == 9
        tconfig.set("observability.flight_recorder_size", 0)
        flightrec.clear()
        _fill(events, 3)
        assert flightrec.snapshot() == [] and not flightrec.active()
        assert flightrec.dump("unit") is None
    finally:
        jconfig.unset("observability.flight_recorder_size")


def test_flight_recorder_default_is_on_at_256():
    assert tconfig.get("observability.flight_recorder_size") == 256
    assert flightrec.active() and events.recording_enabled()
    _fill(events, 300)
    assert len(flightrec.snapshot()) == 256


def test_watchdog_stall_on_a_fake_clock_dumps_the_ring(tmp_path):
    """No events path, the ring on: a stall found on an injected clock
    writes a flight-recorder dump (reason ``watchdog.stall.<name>``) next
    to the working directory, holding the stall event itself."""
    clock = [100.0]
    watchdog.set_clock(lambda: clock[0])
    hb = watchdog.register("unit.stuck", timeout_s=2.0)
    try:
        _fill(events, 3)
        clock[0] = 103.0
        fired = watchdog.Watchdog(stall_timeout_s=2.0, start=False).check()
    finally:
        hb.close()
    assert [s.name for s in fired] == ["unit.stuck"]
    dumps = sorted(p for p in os.listdir(tmp_path)
                   if p.startswith("flightrec-"))
    assert len(dumps) == 1
    lines = [json.loads(l) for l in open(tmp_path / dumps[0])]
    assert lines[0]["reason"] == "watchdog.stall.unit.stuck"
    assert lines[-1]["name"] == "watchdog.stall"


def test_cli_crash_dumps_the_ring(tmp_path, monkeypatch, capsys):
    """An unhandled exception in a CLI command dumps the ring with reason
    ``crash`` and still propagates."""
    def boom(args, passthrough):
        raise RuntimeError("unit crash")
    monkeypatch.setattr(cli, "cmd_loadgen", boom)
    _fill(events, 2)
    with pytest.raises(RuntimeError, match="unit crash"):
        cli.main(["loadgen", "--rate", "1", "--duration", "1"])
    assert "flight recorder dumped to" in capsys.readouterr().err
    dumps = [p for p in os.listdir(tmp_path) if p.startswith("flightrec-")]
    assert len(dumps) == 1
    assert json.loads(open(tmp_path / dumps[0]).readline())["reason"] == \
        "crash"


def test_profiling_trace_writes_a_chrome_trace_and_nests_as_a_noop(
        tmp_path, caplog):
    """``trace`` writes a torch.profiler Chrome trace of the region into
    ``profiling.trace_dir``; a nested ``trace`` warns and does nothing,
    and the outer capture still writes its one trace. ``annotate`` names
    a region of that trace; an error inside the region propagates."""
    import torch
    out = tmp_path / "traces"
    tconfig.set("profiling.trace_dir", str(out))
    log = logging.getLogger("mmlspark_tpu_torch.profiling")
    log.addHandler(caplog.handler)      # the port's loggers do not propagate
    try:
        with profiling.trace():
            with profiling.trace(str(tmp_path / "inner")):
                with profiling.annotate("unit.region"):
                    torch.ones(8).sum()
    finally:
        log.removeHandler(caplog.handler)
    assert "nested trace" in caplog.text
    assert not (tmp_path / "inner").exists()
    written = os.listdir(out)
    assert len(written) == 1 and written[0].endswith(".json")
    assert "unit.region" in (out / written[0]).read_text()
    with pytest.raises(ValueError):
        with profiling.trace(str(tmp_path / "err")):
            raise ValueError("propagates")
    tconfig.unset("profiling.trace_dir")
    with profiling.trace():           # no directory: a no-op
        pass


def test_annotated_spans_mark_the_profiler_trace(tmp_path):
    """With ``observability.annotate`` on, a span opens a
    ``record_function`` of its name."""
    import torch
    tconfig.set("observability.annotate", True)
    with profiling.trace(str(tmp_path)):
        with spans.span("fit", "Annotated"):
            torch.ones(4).sum()
    (name,) = os.listdir(tmp_path)
    assert "fit:Annotated" in (tmp_path / name).read_text()


def test_cli_report_json_text_and_trace(tmp_path, capsys):
    """``report EVENTS --json`` prints the structured report, equal to the
    JAX package's; the text form its render; ``--trace`` also writes the
    Chrome trace, which validates; ``--glob`` merges sidecars."""
    path = _write(tmp_path / "events.jsonl", _fixture_events())
    assert cli.main(["report", path, "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == \
        json.loads(json.dumps(jreport.build_report(path), sort_keys=True))
    assert cli.main(["report", path, "--top", "3"]) == 0
    assert capsys.readouterr().out == jreport.render_report(path, top=3) \
        + "\n"
    out = str(tmp_path / "t.json")
    assert cli.main(["report", path, "--trace", out, "--json"]) == 0
    assert capsys.readouterr().out.startswith("trace: ")
    assert trace.validate_trace(json.load(open(out))) == []
    _write(tmp_path / "events-2.jsonl", _fixture_events()[:3])
    assert cli.main(["report", "--glob", str(tmp_path / "events*.jsonl"),
                     "--json"]) == 0
    assert len(json.loads(capsys.readouterr().out)["paths"]) == 2
    with pytest.raises(SystemExit):
        cli.main(["report", "--glob", str(tmp_path / "none-*.jsonl")])


def test_launch_pod_argv_contract(capsys):
    """The per-host ssh argv of a GPU pod launch, as the reference's
    launch-pod test pins its gcloud argv: host order gives the process
    ids, host 0 is the rendezvous through ``run --hosts``, the mesh and
    the script's arguments pass through shell-quoted, a leading ``~`` of
    the app dir stays unquoted only in a user-name shape, and a bad
    ``--mesh`` fails before anything is built."""
    assert cli.main(["launch-pod", "gpu-a,gpu-b", "train.py", "--mesh",
                     "data=-1,tensor=2", "--app-dir", "/opt/my app",
                     "--dry-run", "--", "--alpha", "a b"]) == 0
    argvs = json.loads(capsys.readouterr().out)
    assert argvs == [
        ["ssh", host, "cd '/opt/my app' && python -m mmlspark_tpu_torch.cli "
         f"run train.py --hosts gpu-a,gpu-b --process-id {i} --mesh "
         "data=-1,tensor=2 -- --alpha 'a b'"]
        for i, host in enumerate(["gpu-a", "gpu-b"])]
    assert cli.main(["launch-pod", "h0", "t.py", "--dry-run"]) == 0
    assert json.loads(capsys.readouterr().out) == [
        ["ssh", "h0", "cd ~/app && python -m mmlspark_tpu_torch.cli run "
         "t.py --hosts h0 --process-id 0"]]
    import argparse
    ns = argparse.Namespace(hosts="h0", script="t.py", mesh="",
                            app_dir="~svc/my app")
    tail = " && python -m mmlspark_tpu_torch.cli run t.py --hosts h0 " \
           "--process-id 0"
    assert cli.build_pod_argv(ns, [])[0][-1] == "cd ~svc/'my app'" + tail
    ns.app_dir = "~svc"
    assert cli.build_pod_argv(ns, [])[0][-1] == "cd ~svc" + tail
    ns.app_dir = "~x;rm -rf y/app"
    assert cli.build_pod_argv(ns, [])[0][-1] == \
        "cd '~x;rm -rf y/app'" + tail
    with pytest.raises(SystemExit):
        cli.main(["launch-pod", "h0", "t.py", "--mesh", "bogus=2",
                  "--dry-run"])
