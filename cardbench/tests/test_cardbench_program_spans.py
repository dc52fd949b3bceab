"""The readers of the port's own spans (``program_spans.py``): each on a
synthetic record; the existing readers unmoved by the new key; idle gaps
named by program spans first; the bridge from the port's collector, and
each cell driven on the CPU with it wired beside the tracer. On a card,
the clock check: each ``score:fetch`` span of a traced featurize stretch
ends after the device-to-host copy it waited for, and within 2 ms of it.
Run that one with ``python -m pytest -m cuda cardbench/tests``."""
import time

import numpy as np
import pytest

from cardbench import program_spans, tracing
from cardbench.harness import Cell, benchmark, reader, run_cell
from cardbench.tests.test_cardbench_correctness import small

# the per-layer entries that read program spans, as BENCHMARK.json would
# list them
PROGRAM_METRICS = [
    ("prep_ms.featurize", "ms", "featurize pass", "images_per_s",
     ["resnet50.featurize"]),
    ("stack_ms.featurize", "ms", "featurize pass", "images_per_s",
     ["resnet50.featurize"]),
    ("upload_ms.featurize", "ms", "host-device copies", "images_per_s",
     ["resnet50.featurize"]),
    ("fetch_wait_ms.featurize", "ms", "featurize pass", "images_per_s",
     ["resnet50.featurize"]),
    ("executor_busy.serve", "%", "serving seam", "p95_ms",
     ["resnet50.serve"]),
    ("batch_host_ms.serve", "ms", "serving seam", "p95_ms",
     ["resnet50.serve"]),
    ("offcpu_share.serve", "%", "serving seam", "p95_ms",
     ["resnet50.serve"]),
    ("launch_ms.train", "ms", "train step", "train_images_per_s",
     ["vit_b16.train", "vit_b16.train_dp4"]),
]


def _entry(name, unit, layer, moves, cells):
    return {"name": name, "unit": unit, "better": "lower",
            "source": "program_span", "layer": layer, "moves": moves,
            "workloads": cells}


def _span(i, name, start, end, parent=None, thread=1, cpu=None, **attrs):
    return {"name": name, "span_id": i, "parent_id": parent,
            "thread": thread, "start_s": start, "end_s": end,
            "cpu_s": end - start if cpu is None else cpu, "attrs": attrs}


def _rec(spans, window=3.0):
    return {"window_s": window, "program_spans": spans}


def test_the_entries_keep_to_the_contract():
    layers = {m["layer"] for m in benchmark()["per_layer"]}
    moved = {m["name"] for m in benchmark()["end_to_end"]}
    for m in PROGRAM_METRICS:
        e = _entry(*m)
        assert e["layer"] in layers and e["moves"] in moved
        assert callable(reader(e["name"]))
        for cell in e["workloads"]:
            assert e["moves"] in {x["name"] for x in Cell(cell).e2e}


def test_the_featurize_readers_average_whole_frames():
    spans = [
        # a frame cut by the stretch's start: not counted
        _span(1, "transform:ImageFeaturizer", -0.2, 0.3),
        _span(2, "score:fetch", 0.1, 0.3, parent=1),
        # two whole frames
        _span(3, "transform:ImageFeaturizer", 0.5, 1.3),
        _span(4, "featurize:prep", 0.5, 0.6, parent=3),
        _span(5, "transform:TorchModel", 0.6, 1.3, parent=3),
        _span(6, "score:stack", 0.6, 0.7, parent=5),
        _span(7, "score:upload", 0.7, 0.75, parent=5),
        _span(8, "score:fetch", 0.8, 1.2, parent=5),
        _span(9, "transform:ImageFeaturizer", 1.5, 2.5),
        _span(10, "featurize:prep", 1.5, 1.8, parent=9),
        _span(11, "transform:TorchModel", 1.8, 2.5, parent=9),
        _span(12, "score:stack", 1.8, 1.9, parent=11),
        _span(13, "score:upload", 1.9, 2.0, parent=11),
        _span(14, "score:launch", 2.0, 2.1, parent=11),
        _span(15, "score:fetch", 2.1, 2.2, parent=14),
        _span(16, "score:fetch", 2.2, 2.4, parent=11),
    ]
    rec = _rec(spans)
    assert np.isclose(reader("prep_ms.featurize")(rec), 200.0)
    assert np.isclose(reader("stack_ms.featurize")(rec), 100.0)
    assert np.isclose(reader("upload_ms.featurize")(rec), 75.0)
    # the nested window fetch counts as the direct one does
    assert np.isclose(reader("fetch_wait_ms.featurize")(rec), 350.0)


def test_the_serve_readers():
    spans = [
        _span(1, "serve:batch", -0.1, 0.5),
        _span(2, "batch:take", -0.1, 0.0, parent=1),
        _span(3, "serve:batch", 1.0, 1.5, rows=3),
        _span(4, "batch:take", 1.0, 1.1, parent=3, cpu=0.05),
        _span(5, "batch:pad", 1.1, 1.2, parent=3, cpu=0.1),
        _span(6, "batch:copy_in", 1.2, 1.25, parent=3),
        _span(7, "batch:replay", 1.25, 1.3, parent=3),
        _span(8, "batch:fetch", 1.3, 1.4, parent=3),
        _span(9, "batch:respond", 1.4, 1.5, parent=3, cpu=0.05),
        _span(10, "serve:batch", 2.5, 3.5),
        _span(11, "serve:wait", 0.5, 1.0, thread=2),
    ]
    rec = _rec(spans)
    # 0.5 + 0.5 + 0.5 of the batches inside 3 s
    assert np.isclose(reader("executor_busy.serve")(rec), 50.0)
    assert np.isclose(reader("batch_host_ms.serve")(rec), 350.0)
    assert np.isclose(reader("offcpu_share.serve")(rec), 100 * (1 - 0.2 / 0.3))


def test_launch_ms_leaves_the_ring_read_out():
    spans = [
        _span(1, "train:step", 0.0, 0.02),
        _span(2, "train:forward", 0.0, 0.01, parent=1),
        _span(3, "train:step", 0.1, 0.2),
        _span(4, "train:flush", 0.11, 0.17, parent=3),
        _span(5, "train:step", 2.9, 3.1),
    ]
    assert np.isclose(reader("launch_ms.train")(_rec(spans)), 30.0)


def test_the_readers_read_nothing_without_program_spans():
    for m in PROGRAM_METRICS:
        assert reader(m[0])({"window_s": 3.0}) is None, m[0]
        assert reader(m[0])(_rec([])) is None, m[0]


def _real_shaped(cell):
    """A record every existing reader of ``cell`` reads a number from."""
    ops = [("void crop_resize_normalize_kernel<1>", 0, 0.1, 0.002),
           ("fused_normalize_kernel", 0, 0.2, 0.001),
           ("Memcpy HtoD (Pageable -> Device)", 0, 0.3, 0.004),
           ("ncclDevKernel_AllReduce_Sum_bf16", 0, 0.4, 0.003),
           ("void at::native::elementwise_kernel", 0, 0.5, 0.5)]
    lane = {"images": 640, "batch": 128, "batches": 5, "steps": 5,
            "train": cell.endswith(("train", "train_dp4")),
            "src": [256, 256, 3], "image": [224, 224, 3], "out_bytes": 2,
            "replays": {32: 10, 64: 5}, "queue_ms_sum": 120.0, "queue_n": 30,
            "nccl_s": [0.015, 0.016], "over_busy": cell.endswith("serve")}
    return {"window_s": 3.0, "busy_s": [1.5], "ops": ops, "spans": [],
            "lane": lane, "cfg": Cell(cell).cfg, "traffic": {}, "chips": 1}


def test_the_existing_readers_read_the_same_beside_program_spans():
    spans = [_span(1, "serve:batch", 0.1, 0.2),
             _span(2, "transform:ImageFeaturizer", 0.3, 0.9)]
    existing = [m for m in benchmark()["per_layer"]
                if m["source"] != "program_span"]
    for m in existing:
        for cell in m["workloads"]:
            rec = _real_shaped(cell)
            want = reader(m["name"])(rec)
            assert want is not None, (m["name"], cell)
            assert reader(m["name"])(dict(rec, program_spans=spans)) == want


def test_idle_gaps_are_named_by_the_program_span_covering_most():
    w0 = 10_000_000_000
    rec = {"window_ns": (w0, w0 + 3_000_000_000),
           "busy_intervals": [(w0 + 500_000_000, w0 + 1_000_000_000),
                              (w0 + 1_200_000_000, w0 + 2_900_000_000)],
           "spans": [("transform", 0.0, 3.0, 1)],
           "program_spans": [
               # open when the 0.2-s gap began, but covering little of it
               _span(1, "transform:ImageFeaturizer", 0.8, 1.01),
               _span(2, "score:fetch", 0.9, 1.01, parent=1),
               _span(3, "transform:ImageFeaturizer", 1.02, 1.3, thread=7),
               _span(4, "featurize:prep", 1.02, 1.15, parent=3, thread=7)]}
    assert tracing.idle_gaps_top(rec) == [
        ["transform", 0.5], ["transform", pytest.approx(0.2)],
        ["transform", pytest.approx(0.1)]]
    assert program_spans.idle_gaps_top(rec) == [
        ["transform", 0.5], ["featurize:prep", pytest.approx(0.2)],
        ["transform", pytest.approx(0.1)]]
    assert program_spans.idle_gaps_top(dict(rec, program_spans=[])) == \
        tracing.idle_gaps_top(rec)


def test_the_bridge_puts_the_ports_spans_on_the_stretchs_seconds():
    from mmlspark_tpu_torch.observability import spans
    assert program_spans.start()
    w0 = time.time_ns()
    with spans.span("serve", "batch", hot=True, rows=2):
        with spans.span("batch", "take", hot=True):
            pass
    rec = {"window_ns": (w0, time.time_ns())}
    program_spans.stop(rec)
    got = {s["name"]: s for s in rec["program_spans"]}
    assert rec["program_spans_dropped"] == 0
    assert got["batch:take"]["parent_id"] == got["serve:batch"]["span_id"]
    assert got["serve:batch"]["attrs"] == {"rows": 2}
    assert 0 <= got["serve:batch"]["start_s"] <= got["batch:take"]["start_s"] \
        <= got["batch:take"]["end_s"] <= got["serve:batch"]["end_s"] \
        <= (rec["window_ns"][1] - w0) / 1e9
    program_spans.stop(rec)
    assert rec["program_spans"] == []


@pytest.fixture
def wired(monkeypatch):
    """The tracer with the port's collector wired beside it."""
    start, stop = tracing.Tracer.start, tracing.Tracer.stop

    def wired_start(self):
        start(self)
        if self._prof is not None:
            program_spans.start()

    def wired_stop(self):
        rec = stop(self)
        if rec is not None:
            program_spans.stop(rec)
        return rec
    monkeypatch.setattr(tracing.Tracer, "start", wired_start)
    monkeypatch.setattr(tracing.Tracer, "stop", wired_stop)


@pytest.fixture
def _cpu_device():
    from mmlspark_tpu_torch.utils import config
    config.set("runtime.device", "cpu")
    yield
    config.unset("runtime.device")


@pytest.mark.parametrize("cell", ["resnet50.featurize", "resnet50.serve",
                                  "vit_b16.train"])
def test_wired_cells_on_the_cpu_read_their_program_metrics(
        cell, wired, _cpu_device):
    c = small(cell)
    # a window that holds a few of the CPU's slow frames and steps, the
    # traced stretch its second half
    c.traffic = dict(c.traffic, trace_seconds=5.0)
    ours = [_entry(*m) for m in PROGRAM_METRICS if cell in m[4]]
    c.per_layer = list(c.per_layer) + ours
    r = run_cell(cell, 2**31 + 23, 10.0, True, time.perf_counter(),
                 device="cpu", cell=c)
    assert r["correct"]
    for m in ours:
        assert m["name"] in r["metrics"], m["name"]
        assert r["metrics"][m["name"]]["value"] >= 0, m["name"]


@pytest.mark.cuda
def test_each_fetch_ends_after_its_copy_back_and_within_2_ms():
    """The port's clock and the profiler's agree: a ``score:fetch`` span
    waits for the device-to-host copy of its output, so it ends after that
    copy, and it ends soon after it."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cardbench import gen, weights
    from cardbench.lanes.featurize import _frames, featurizer, served_dtype
    from cardbench.harness import Context, Cell as HCell
    cell = HCell("resnet50.featurize")
    cfg, tr = cell.cfg, cell.traffic
    dev = torch.device("cuda")
    params = weights.make(cfg, 2**31 + 5, dev, round_to=served_dtype(cfg))
    pool = gen.image_pool(tr["pool_images"], tr["image"], 2**31 + 5, dev)
    ctx = Context(cell, 2**31 + 5, 1.0, True, dev, time.perf_counter())
    fz = featurizer(cfg, tr, params)
    frames = _frames(ctx, pool)
    fz.transform(next(frames)[1]).column("features")
    tracer = tracing.Tracer(True)
    tracer.warm()
    tracer.start()
    assert program_spans.start()
    for _ in range(3):
        fz.transform(next(frames)[1]).column("features")
    rec = tracer.stop()
    program_spans.stop(rec)
    fetches = [s for s in rec["program_spans"] if s["name"] == "score:fetch"]
    copies = [(s, s + d) for n, _, s, d in rec["ops"] if "DtoH" in n]
    assert len(fetches) == 3 and copies
    for f in fetches:
        mine = [c for c in copies if f["start_s"] <= c[0] <= f["end_s"]]
        assert mine, f
        end = max(e for _, e in mine)
        assert end <= f["end_s"] <= end + 0.002, (f, end)
