"""The port's span collector and its hot spans, on the CPU.

The collector (``spans.collect_start`` .. ``collect_stop``) is the third
sink of ``span()``: it keeps each span's ``time.time_ns()`` bracket, its
thread and the thread CPU time it covered, for a run to read back. Hot
spans mark the featurize pass, the serving executor and the train step;
with no sink live a hot span is the shared no-op after one flag read, and
no hot span ever enters the flight recorder's ring. Also here: the
serving histograms' millisecond buckets.
"""
import contextvars
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.core.schema import ColumnSchema, DType, ImageValue
from mmlspark_tpu_torch.image.featurizer import ImageFeaturizer
from mmlspark_tpu_torch.models import residency
from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.observability import events, flightrec, metrics
from mmlspark_tpu_torch.observability import spans, syncs
from mmlspark_tpu_torch.parallel import optim
from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer
from mmlspark_tpu_torch.serve import Server
from mmlspark_tpu_torch.testing.ranks import RankPool
from mmlspark_tpu_torch.utils import config

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)


@pytest.fixture(autouse=True)
def _clean():
    config.set("runtime.device", "cpu")
    flightrec.clear()
    residency.clear()
    yield
    spans.collect_stop()
    for key in ("runtime.device", "observability.events_path",
                "observability.flight_recorder_size",
                "observability.annotate", "observability.metrics",
                "train.metrics_flush_steps"):
        config.unset(key)
    events.close()
    events.reset_clock()
    flightrec.clear()
    residency.clear()


def _collected(fn):
    """Run ``fn`` with the collector on: the spans it collected."""
    spans.collect_start()
    try:
        fn()
    finally:
        got, dropped = spans.collect_stop()
    assert dropped == 0
    return got


def _tree(got):
    """{name: [parent's name]} of collected spans."""
    names = {s["span_id"]: s["name"] for s in got}
    out = {}
    for s in got:
        out.setdefault(s["name"], []).append(names.get(s["parent_id"]))
    return out


def _children(got, parent):
    """The names of ``parent``'s children, in the order they opened."""
    return [s["name"] for s in sorted(got, key=lambda s: s["span_id"])
            if s["parent_id"] == parent["span_id"]]


# -- the collector ---------------------------------------------------------------

def test_the_collector_keeps_what_closed_while_it_was_on():
    with spans.span("before", hot=True):
        pass
    assert spans.collect_stop() == ([], 0)
    spans.collect_start()
    t0 = time.time_ns()
    with spans.span("a", "b", hot=True, rows=3):
        pass
    with spans.span("cold"):
        pass
    t1 = time.time_ns()
    got, dropped = spans.collect_stop()
    with spans.span("after", hot=True):
        pass
    assert [s["name"] for s in got] == ["a:b", "cold"] and dropped == 0
    assert spans.collect_stop() == ([], 0)
    a = got[0]
    assert set(a) == {"name", "span_id", "parent_id", "thread", "start_ns",
                      "end_ns", "cpu_ns", "attrs"}
    assert a["attrs"] == {"rows": 3} and a["parent_id"] is None
    assert a["thread"] == threading.get_ident()
    assert t0 <= a["start_ns"] <= a["end_ns"] <= got[1]["start_ns"] \
        <= got[1]["end_ns"] <= t1


def test_the_collector_is_bounded_and_counts_what_it_dropped():
    spans.collect_start(capacity=2)
    for i in range(5):
        with spans.span("s", str(i), hot=True):
            pass
    got, dropped = spans.collect_stop()
    assert [s["name"] for s in got] == ["s:0", "s:1"] and dropped == 3


def test_an_injected_wall_clock_drives_the_collector():
    events.set_clock(wall_fn=lambda: 1_700_000_000.25)
    got = _collected(lambda: spans.span("x", hot=True).__enter__()
                     .__exit__(None, None, None))
    assert got[0]["start_ns"] == got[0]["end_ns"] == 1_700_000_000_250_000_000


def test_parent_ids_across_nesting_and_threads():
    seen = {}

    def work():
        with spans.span("outer", hot=True) as outer:
            with spans.span("inner", hot=True):
                pass
            seen["outer"] = outer.span_id

            def in_thread():
                with spans.span("thread_root", hot=True):
                    pass
            t = threading.Thread(target=in_thread, daemon=True)
            t.start()
            t.join(10)
            ctx = contextvars.copy_context()
            t = threading.Thread(target=lambda: ctx.run(
                lambda: spans.span("thread_child", hot=True).__enter__()
                .__exit__(None, None, None)), daemon=True)
            t.start()
            t.join(10)
            assert not t.is_alive()
    got = {s["name"]: s for s in _collected(work)}
    assert got["inner"]["parent_id"] == seen["outer"]
    assert got["outer"]["parent_id"] is None
    assert got["thread_root"]["parent_id"] is None
    assert got["thread_child"]["parent_id"] == seen["outer"]
    assert got["thread_root"]["thread"] != got["outer"]["thread"]


def test_thread_cpu_is_no_more_than_wall():
    def work():
        with spans.span("busy", hot=True):
            end = time.thread_time_ns() + 20_000_000
            while time.thread_time_ns() < end:
                pass
        with spans.span("sleep", hot=True):
            time.sleep(0.02)
    got = {s["name"]: s for s in _collected(work)}
    for s in got.values():
        assert s["cpu_ns"] <= s["end_ns"] - s["start_ns"] + 1_000_000
    assert got["busy"]["cpu_ns"] >= 20_000_000
    assert got["sleep"]["cpu_ns"] < 10_000_000


# -- cost and sinks ----------------------------------------------------------------

def test_with_every_sink_off_a_span_reads_no_config(monkeypatch):
    config.set("observability.flight_recorder_size", 0)

    def boom(*a, **k):
        raise AssertionError("config.get on the disabled path")
    monkeypatch.setattr(config, "get", boom)
    assert spans.span("serve", "batch", hot=True) is spans._NOOP
    assert spans.span("fit", "x") is spans._NOOP
    syncs.sync_point("unit.site")
    with spans.span("serve", "batch", hot=True) as s:
        s.set(rows=1)


def test_a_hot_span_is_off_while_only_the_ring_is_on():
    assert flightrec.active()
    assert spans.span("batch", "take", hot=True) is spans._NOOP
    assert spans.span("fit", "x") is not spans._NOOP


def test_hot_spans_never_enter_the_ring(tmp_path):
    path = tmp_path / "events.jsonl"
    config.set("observability.events_path", str(path))

    def work():
        with spans.span("train", "step", hot=True):
            with spans.span("cold"):
                pass
    got = _collected(work)
    events.close()
    assert [s["name"] for s in got] == ["cold", "train:step"]
    assert [e["name"] for e in flightrec.snapshot()] == ["cold"]
    logged = [e["name"] for e in map(json.loads, open(path))
              if e["type"] == "span"]
    assert logged == ["cold", "train:step"]


def test_an_environment_key_changed_after_import_is_seen(tmp_path, monkeypatch):
    assert spans.span("x", hot=True) is spans._NOOP
    monkeypatch.setenv("MMLSPARK_TPU_TORCH_OBSERVABILITY_EVENTS_PATH",
                       str(tmp_path / "e.jsonl"))
    assert events.recording_enabled()
    assert spans.span("x", hot=True) is not spans._NOOP
    monkeypatch.delenv("MMLSPARK_TPU_TORCH_OBSERVABILITY_EVENTS_PATH")
    spans.refresh()
    assert spans.span("x", hot=True) is spans._NOOP


def test_a_hot_span_inside_one_of_its_name_is_not_opened_again():
    def work():
        with spans.span("transform", "TorchModel"):
            with spans.span("transform", "TorchModel", hot=True):
                with spans.span("score", "emit", hot=True):
                    pass
    tree = _tree(_collected(work))
    assert tree == {"transform:TorchModel": [None],
                    "score:emit": ["transform:TorchModel"]}


# -- the three paths ---------------------------------------------------------------

def _u8_frame(n=6, size=32):
    imgs = np.empty(n, dtype=object)
    rng = np.random.default_rng(0)
    for i in range(n):
        imgs[i] = ImageValue(path=f"mem://{i}", data=rng.integers(
            0, 256, (size, size, 3), dtype=np.uint8))
    frame = Frame.from_dict({"row": np.arange(n)}, num_partitions=2)
    return frame.with_column_values(ColumnSchema("image", DType.IMAGE), imgs)


def test_one_featurize_pass_gives_the_featurize_nesting_once_each():
    fz = ImageFeaturizer(inputCol="image", outputCol="features",
                         miniBatchSize=4).set_model(
        "resnet20_cifar", num_classes=10, dtype="float32")
    frame = _u8_frame()
    got = _collected(lambda: fz.transform(frame))
    assert _tree(got) == {
        "transform:ImageFeaturizer": [None],
        "featurize:prep": ["transform:ImageFeaturizer"],
        "transform:TorchModel": ["transform:ImageFeaturizer"],
        "score:stack": ["transform:TorchModel"],
        "score:upload": ["transform:TorchModel"],
        "score:launch": ["transform:TorchModel"],
        "score:fetch": ["transform:TorchModel"],
        "score:emit": ["transform:TorchModel"]}
    by = {s["name"]: s for s in got}
    assert _children(got, by["transform:TorchModel"]) == [
        "score:stack", "score:upload", "score:launch", "score:fetch",
        "score:emit"]
    assert by["featurize:prep"]["attrs"] == {"rows": 6}
    assert by["score:upload"]["attrs"] == {"bytes": 2 * 4 * 32 * 32 * 3}
    assert by["score:launch"]["attrs"] == {"batches": 2}
    assert by["score:fetch"]["attrs"]["bytes"] > 0
    # the memo's second pass skips the prep and the upload
    again = _tree(_collected(lambda: fz.transform(frame)))
    assert "featurize:prep" not in again and "score:upload" not in again


def test_the_streaming_loop_gives_its_stages():
    tm = TorchModel(inputCol="x", outputCol="y", miniBatchSize=4,
                    deviceCache="off").set_model(
        "mlp_tabular", input_dim=8, hidden=[16], num_classes=3)
    frame = Frame.from_dict({"x": np.ones((10, 8), np.float32)})
    tree = _tree(_collected(lambda: tm.transform(frame)))
    assert tree["transform:TorchModel"] == [None]
    for name in ("score:stack", "score:upload", "score:launch",
                 "score:emit"):
        assert tree[name] == ["transform:TorchModel"], name
    assert tree["score:fetch"] == ["transform:TorchModel"]


def _mlp():
    m = TorchModel(inputCol="x", outputCol="y", miniBatchSize=8)
    return m.set_model("mlp_tabular", input_dim=8, hidden=[16],
                       num_classes=3)


def test_a_server_gives_one_batch_span_per_flush_with_six_stages():
    srv = Server({"mlp": _mlp()}, max_batch=8, buckets=(4, 8), start=False)
    try:
        def work():
            futs = [srv.submit_async("mlp", np.zeros(8, np.float32))
                    for _ in range(3)]
            assert srv.pump() == 1
            for f in futs:
                f.result(10)
            f = srv.submit_async("mlp", np.zeros((5, 8), np.float32))
            assert srv.pump() == 1
            f.result(10)
        got = _collected(work)
    finally:
        srv.close()
    batches = [s for s in got if s["name"] == "serve:batch"]
    assert [b["attrs"] for b in batches] == [
        {"rows": 3, "bucket": 4, "tickets": 3},
        {"rows": 5, "bucket": 8, "tickets": 1}]
    for b in batches:
        assert b["parent_id"] is None
        assert _children(got, b) == [
            "batch:take", "batch:pad", "batch:copy_in", "batch:replay",
            "batch:fetch", "batch:respond"]


def test_the_executor_thread_spans_its_waits():
    with Server({"mlp": _mlp()}, max_batch=8, max_wait_ms=1.0) as srv:
        # the wait between the two requests opens and closes inside
        got = _collected(lambda: [srv.submit("mlp", np.zeros(8, np.float32),
                                             timeout=30) for _ in range(2)])
    names = {s["name"] for s in got}
    assert {"serve:wait", "serve:batch", "batch:replay"} <= names
    executor = {s["thread"] for s in got if s["name"] == "serve:batch"}
    assert executor and threading.get_ident() not in executor


def _linear_trainer():
    trainer = DistributedTrainer(
        lambda m, b, g: ((m(b["x"]) - b["y"]) ** 2).mean(), optim.sgd(0.1),
        device=torch.device("cpu"))
    state = trainer.init(lambda: torch.nn.Linear(4, 2))
    batch = {"x": torch.ones(8, 4), "y": torch.zeros(8, 2)}
    return trainer, state, batch


def test_a_train_step_gives_its_phases():
    config.set("train.metrics_flush_steps", 2)
    trainer, state, batch = _linear_trainer()
    got = _collected(lambda: [trainer.train_step(state, batch, 0)
                              for _ in range(2)])
    steps = [s for s in got if s["name"] == "train:step"]
    assert len(steps) == 2
    assert _children(got, steps[0]) == [
        "train:forward", "train:backward", "train:update", "train:ring"]
    assert _children(got, steps[1]) == [
        "train:forward", "train:backward", "train:update", "train:ring",
        "train:flush"]


def test_a_two_rank_step_gives_the_allreduce():
    pool = RankPool(2, paths=[TESTS, REPO])
    try:
        ranks = pool.run("torch_mesh_ranks:step_spans", {"data": 2})
    finally:
        pool.close()
    for got in ranks:
        parents = {n: p for n, p, _ in got}
        assert parents["train:allreduce"] == "train:step"
        assert parents["train:forward"] == "train:step"
        attrs = [a for n, _, a in got if n == "train:allreduce"][0]
        # the weight (2x4) and the bias (2) in float32
        assert attrs == {"bytes": (8 + 2) * 4}


# -- the serving histograms' milliseconds -------------------------------------------

def test_served_latencies_over_ten_ms_read_past_ten():
    srv = Server({"mlp": _mlp()}, max_batch=8, start=False)
    try:
        for _ in range(200):
            srv.latency.observe(76.0)
        s = srv.stats()
    finally:
        srv.close()
    assert 50.0 < s["p50_ms"] <= 100.0 and 50.0 < s["p99_ms"] <= 100.0


def test_the_server_histograms_observe_in_milliseconds():
    config.set("observability.metrics", True)
    srv = Server({"mlp": _mlp()}, max_batch=8, start=False)
    try:
        f = srv.submit_async("mlp", np.zeros(8, np.float32))
        srv.pump()
        f.result(10)
    finally:
        srv.close()
    dump = metrics.get_registry().to_dict()
    for name in ("serving.queue_ms", "serving.pad_ms", "serving.compute_ms",
                 "serving.total_ms"):
        assert repr(60000.0) in dump[name]["buckets"], name
    assert srv.latency.buckets == metrics.MS_BUCKETS
