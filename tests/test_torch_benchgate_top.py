"""The port's bench gate and ``top`` against the JAX package's.

``benchgate.compare`` is pure data: its verdict on the committed bench
lines (every ``BENCH_r*.json`` pair against ``BENCH_r11.json`` /
``BENCH_r12.json``) and on synthetic clipped, legacy and skipped lanes must
equal the reference's dict for dict. ``TopDashboard.render`` must give the
reference's text for the same snapshots, frame after frame (rates come from
the previous frame), with the workload, decode, affinity, SLO, autopilot
and worker lines.
"""
import glob
import io
import json
import os

import pytest

from mmlspark_tpu.observability import benchgate as jgate
from mmlspark_tpu.observability.aggregate import FleetScraper as JScraper
from mmlspark_tpu.observability.dashboard import TopDashboard as JTop
from mmlspark_tpu_torch.observability import benchgate
from mmlspark_tpu_torch.observability.aggregate import FleetScraper
from mmlspark_tpu_torch.observability.dashboard import (
    TopDashboard, format_bytes,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCHES = sorted(glob.glob(os.path.join(ROOT, "BENCH_r*.json")))


def _parsed(path):
    with open(path) as f:
        data = json.load(f)
    return data.get("parsed") or data


@pytest.mark.parametrize("fresh", [os.path.basename(p) for p in BENCHES])
@pytest.mark.parametrize("base", ["BENCH_r11.json", "BENCH_r12.json"])
def test_compare_equals_the_reference_on_committed_lines(fresh, base):
    line = _parsed(os.path.join(ROOT, fresh))
    baseline = benchgate.load_baseline(os.path.join(ROOT, base))
    assert baseline == jgate.load_baseline(os.path.join(ROOT, base))
    for tol in (0.10, 0.02):
        assert benchgate.compare(line, baseline, tol) == \
            jgate.compare(line, baseline, tol)


def _lane(**kw):
    lane = {"value": 100.0, "step_ms": 10.0, "deadline_ms": 200.0,
            "arrival_p99_ms": 50.0, "goodput": 0.99}
    lane.update(kw)
    return lane


SYNTHETIC = {
    "green": ({"a": _lane()}, {"a": _lane()}),
    "slower": ({"a": _lane(value=80.0, step_ms=13.0)}, {"a": _lane()}),
    "fresh_clipped": ({"a": _lane(arrival_p99_ms=200.0)}, {"a": _lane()}),
    "base_clipped": ({"a": _lane()}, {"a": _lane(arrival_p99_ms=200.0)}),
    "flag_clipped": ({"a": _lane(arrival_p99_ms_clipped=True)},
                     {"a": _lane()}),
    "both_clipped": ({"a": _lane(arrival_p99_ms=200.0)},
                     {"a": _lane(arrival_p99_ms=200.0)}),
    "resolution_floor": ({"a": _lane(arrival_p99_ms=8.0)},
                         {"a": _lane(arrival_p99_ms=4.0)}),
    "headroom": ({"a": _lane(arrival_p99_ms=19.0, deadline_ms=500.0)},
                 {"a": _lane(arrival_p99_ms=8.0, deadline_ms=500.0)}),
    "legacy_spike": ({"a": {"value": 1.0, "spike_p99_ms": 90.0}},
                     {"a": {"value": 1.0, "spike_p99_ms": 9.0}}),
    "skipped_base": ({"a": _lane()}, {"a": {"skipped": True}}),
    "skipped_fresh": ({"a": {"skipped": True, "reason": "no card"}},
                      {"a": _lane()}),
    "missing_fresh": ({}, {"a": _lane()}),
    "info_fields": ({"a": _lane(compile_ms=900.0, prefix_hit_rate=0.1,
                                steady_compiles=3)},
                    {"a": _lane(compile_ms=100.0, prefix_hit_rate=0.9,
                                steady_compiles=0)}),
}


@pytest.mark.parametrize("case", sorted(SYNTHETIC))
def test_compare_equals_the_reference_on_synthetic_lanes(case):
    fresh, base = SYNTHETIC[case]
    got = benchgate.compare({"configs": fresh}, {"configs": base})
    assert got == jgate.compare({"configs": fresh}, {"configs": base})


def test_gate_reads_a_baseline_file(tmp_path):
    p = tmp_path / "base.json"
    p.write_text(json.dumps({"parsed": {"configs": {"a": _lane()}}}))
    line = {"configs": {"a": _lane(value=50.0)}}
    assert benchgate.gate(line, str(p)) == jgate.gate(line, str(p))
    assert benchgate.gate(line, str(p))["green"] is False
    (tmp_path / "bad.json").write_text("{}")
    with pytest.raises(ValueError, match="not a bench baseline"):
        benchgate.load_baseline(str(tmp_path / "bad.json"))


class _Stats:
    def __init__(self, stats):
        self._stats = stats

    def stats(self):
        return self._stats


class _Meter:
    def result(self):
        return {"offered": 120, "delivered": 118, "goodput": 0.975,
                "arrival_p99_ms": 41.5, "deadline_ms": 200.0, "shed": 2,
                "expired": 0}


def _snap(ts, admitted, shed, **extra):
    snap = {
        "ts": ts, "scrape_ms": 0.7,
        "replicas": {
            "r0": {"ready": True, "state": "ok", "breaker": "closed",
                   "stats": {"admitted": admitted, "queue_depth": 2.0,
                             "inflight": 1.0, "shed": shed,
                             "p50_ms": 3.25, "p99_ms": 9.5}},
            "http://127.0.0.1:8123": {"ready": False, "breaker": "open",
                                      "error": "ConnectionRefusedError: x",
                                      "stats": {}},
        },
        "fleet": {"admitted": admitted, "shed": shed, "expired": 1.0,
                  "failovers": 2.0, "p50_ms": 3.0, "p99_ms": 9.0},
        "memory": {"total_bytes": 3 << 30, "high_watermark_bytes": 4 << 30,
                   "by_kind": {"params": 1 << 30, "kv": 2 << 30},
                   "by_model": {"lm": {"params": 1 << 30, "kv": 2 << 30}}},
    }
    snap.update(extra)
    return snap


FLEET_GEN = {"generate.lm.prefix_hits": 18.0,
             "generate.lm.prefix_misses": 2.0,
             "generate.lm.cow_copies": 3.0,
             "generate.lm.spec_proposed": 10.0,
             "generate.lm.spec_accepted": 9.0,
             "generate.lm.kv.quantized": 1.0,
             "generate.lm.kv.arena_bytes": 1_000_000.0,
             "generate.lm.kv.unquantized_arena_bytes": 4_000_000.0,
             "generate.lm.kv.prefix_hits": 18.0,
             "workload.offered": 40.0, "workload.delivered": 39.0,
             "workload.goodput": 0.9, "workload.arrival_p99_ms": 12.0,
             "workload.deadline_ms": 100.0}

AFFINITY = {"routes": 30.0, "routes_prefix": 20.0, "routes_session": 4.0,
            "routes_wrr": 6.0, "affinity_route_share": 0.8,
            "advertised": [{"replica": "r0", "max_depth": 7},
                           {"replica": "r1", "max_depth": 2}]}

SLO = [{"objective": "availability", "breaching": False, "burning": True,
        "burn_fast": 2.5, "burn_slow": 0.75},
       {"objective": "latency_p99", "breaching": True, "burning": True,
        "burn_fast": 14.0, "burn_slow": 6.0}]

AUTOPILOT = {"ticks": 12, "actions": 3, "suppressed": 1, "errors": 1,
             "recent": [{"action": "shift", "target": "r1"},
                        {"action": "scale_up", "suppressed": True},
                        {"action": "scale_up"}]}

SUPERVISOR = {"desired_replicas": 3, "live_replicas": 2,
              "spawns_in_flight": 1, "retiring": 0,
              "spawn_to_ready_ms": {"count": 2, "p50": 6100.0,
                                    "p99": 7400.0}}


@pytest.mark.parametrize("panel", ["plain", "workload_meter", "gauges",
                                   "affinity_slo", "control"])
def test_render_text_equals_the_reference(panel):
    kw, fleet_extra, snap_extra, slo = {}, {}, {}, None
    if panel == "workload_meter":
        kw = {"workload": _Meter()}
    elif panel == "gauges":
        fleet_extra = FLEET_GEN
    elif panel == "affinity_slo":
        snap_extra, slo = {"affinity": AFFINITY}, SLO
    elif panel == "control":
        kw = {"autopilot": _Stats(AUTOPILOT),
              "supervisor": _Stats(SUPERVISOR)}
    port = TopDashboard(FleetScraper([]), **kw)
    ref = JTop(JScraper([]), **kw)
    for ts, admitted, shed in ((10.0, 100.0, 1.0), (12.0, 140.0, 5.0)):
        snap = _snap(ts, admitted, shed, **snap_extra)
        snap["fleet"].update(fleet_extra)
        got, want = port.render(snap, slo), ref.render(snap, slo)
        assert got == want
        # tick's bookkeeping, so the second frame shows rates
        port._prev = ref._prev = snap
        port._prev_t = ref._prev_t = ts
    assert "qps 20.0" in got and "shed/s 2.0" in got


def test_run_once_prints_one_frame_without_ansi():
    out = io.StringIO()
    TopDashboard(FleetScraper([], clock=lambda: 5.0), clock=lambda: 5.0,
                 out=out).run(once=True)
    frame = out.getvalue()
    assert frame.startswith("mmlspark-tpu top  t=5.0  replicas 0/0 ready")
    assert "\x1b[" not in frame and "hbm      total" in frame


@pytest.mark.parametrize("n", [0, 512, 3 << 20, 5 << 30, 7 << 40])
def test_format_bytes_equals_the_reference(n):
    from mmlspark_tpu.observability.dashboard import format_bytes as jfmt
    assert format_bytes(n) == jfmt(n)


# -- the CLI: top, bench, info --------------------------------------------------

def test_cli_top_once_against_http_server(capsys):
    import threading

    import numpy as np

    from mmlspark_tpu_torch.cli import main
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    from mmlspark_tpu_torch.serve.http import serve_http
    from mmlspark_tpu_torch.serve.server import Server
    from mmlspark_tpu_torch.utils import config as tconfig
    tconfig.set("runtime.device", "cpu")
    model = TorchModel(inputCol="x", outputCol="y")
    model.set_model("mlp_tabular", input_dim=8, hidden=[16], num_classes=3)
    srv = Server({"mlp": model}, max_batch=4, max_wait_ms=1.0)
    httpd, addr = serve_http(srv, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        srv.submit("mlp", np.zeros((2, 8), np.float32), timeout=30)
        assert main(["top", "--replica", addr, "--once"]) == 0
        frame = capsys.readouterr().out
        assert "mmlspark-tpu top" in frame
        assert "replicas 1/1 ready" in frame and addr in frame
    finally:
        srv.close()
        httpd.shutdown()
        httpd.server_close()
        tconfig.unset("runtime.device")
    with pytest.raises(SystemExit):
        main(["top", "--once"])


STUB_BENCH = """
import json, sys
value = float(open("value.txt").read())
print("# stub bench")
print(json.dumps({"metric": "stub", "value": value,
                  "configs": {"lane": {"value": value}}}))
"""


@pytest.mark.parametrize("value,rc", [(100.0, 0), (95.0, 0), (80.0, 1)])
def test_cli_bench_gates_the_bench_line(tmp_path, monkeypatch, capsys,
                                        value, rc):
    from mmlspark_tpu_torch.cli import main
    (tmp_path / "bench.py").write_text(STUB_BENCH)
    (tmp_path / "value.txt").write_text(str(value))
    base = tmp_path / "BENCH_base.json"
    base.write_text(json.dumps({"parsed": {"configs": {
        "lane": {"value": 100.0}}}}))
    monkeypatch.chdir(tmp_path)
    assert main(["bench", "--baseline", str(base)]) == rc
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == "# stub bench"
    verdict = json.loads(out[-1])
    line = json.loads(out[1])
    assert verdict == jgate.gate(line, str(base))
    assert verdict["green"] is (rc == 0)
    # without a baseline the bench's own output is all
    assert main(["bench"]) == 0
    assert len(capsys.readouterr().out.strip().splitlines()) == 2


def test_cli_bench_needs_a_bench_py(tmp_path, monkeypatch):
    from mmlspark_tpu_torch.cli import main
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="no bench.py"):
        main(["bench"])


def test_cli_info_reports_devices_and_config(capsys):
    import torch

    from mmlspark_tpu_torch.cli import main
    assert main(["info"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["platform"] == ("gpu" if torch.cuda.is_available()
                                else "cpu")
    assert info["torch"] == torch.__version__
    assert info["devices"]["process_count"] == 1
    assert info["config"]["runtime.device"] in ("cuda", "cpu")
