"""Traffic generators and weights: deterministic under the seed; the open
loop times each request from when it was due."""
import time
from concurrent.futures import Future

import numpy as np
import torch

from cardbench import gen, weights
from cardbench.harness import Cell
from cardbench.lanes import serve

CPU = torch.device("cpu")


def test_image_pool_and_labels_repeat_under_their_seed():
    a = gen.image_pool(4, (8, 8, 3), 2**31 + 7, CPU)
    b = gen.image_pool(4, (8, 8, 3), 2**31 + 7, CPU)
    c = gen.image_pool(4, (8, 8, 3), 2**31 + 8, CPU)
    assert a.dtype == np.uint8 and a.shape == (4, 8, 8, 3)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert np.array_equal(gen.labels(64, 10, 5), gen.labels(64, 10, 5))
    assert not np.array_equal(gen.labels(64, 10, 5), gen.labels(64, 10, 6))


def test_arrivals_are_the_same_gaps_in_a_seeded_order():
    a = gen.arrivals([[1.0, 500.0]], 3.0, 11)
    b = gen.arrivals([[1.0, 500.0]], 3.0, 11)
    c = gen.arrivals([[1.0, 500.0]], 3.0, 12)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert len(a) == len(c) == 1500
    assert (np.diff(a) > 0).all() and a[0] >= 0 and a[-1] < 3.0
    # every seed sends the same set of gaps (but the few that cross from
    # one phase to the next)
    ga, gc = (np.round(np.diff(x), 9) for x in (a, c))
    assert len(np.intersect1d(ga, gc)) >= len(np.unique(ga)) - 6


def test_arrivals_follow_a_cycle_of_phases():
    due = gen.arrivals([[1.0, 100.0], [1.0, 300.0]], 4.0, 3)
    counts = np.histogram(due, bins=[0, 1, 2, 3, 4])[0]
    assert counts.tolist() == [100, 300, 100, 300]


def test_pool_sequence_is_whole_seeded_permutations():
    seq = gen.pool_sequence(10, 4, 9)
    assert np.array_equal(seq, gen.pool_sequence(10, 4, 9))
    assert sorted(seq[:4]) == [0, 1, 2, 3] and sorted(seq[4:8]) == [0, 1, 2, 3]


def test_weights_repeat_and_round_to_the_served_dtype():
    cfg = Cell("resnet50.featurize").cfg
    a = weights.make(cfg, 7, CPU, round_to=torch.bfloat16)
    b = weights.make(cfg, 7, CPU, round_to=torch.bfloat16)
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)
    w = torch.from_numpy(a["stem_conv.weight"])
    assert torch.equal(w, w.to(torch.bfloat16).float())
    assert a["stem_norm.weight"].mean() > 0.9   # scales sit around one


class _SlowServer:
    """Answers at once, but its first admission blocks ``stall`` seconds,
    so the requests due behind it are sent late."""

    def __init__(self, stall):
        self.stall, self.calls = stall, 0

    def submit_async(self, model, row):
        self.calls += 1
        if self.calls == 1:
            time.sleep(self.stall)
        f = Future()
        f.set_result(np.asarray(row, np.float32)[None, :2])
        return f


def test_open_loop_times_each_request_from_when_it_was_due():
    due = np.array([0.0, 0.01, 0.02, 0.5])
    rows = np.zeros((4, 3), np.uint8)
    loop = serve.OpenLoop(_SlowServer(0.2), rows, due, np.arange(4))
    t0 = time.perf_counter()
    loop.send(t0)
    loop.wait(t0 + 5)
    lat = serve.latencies(loop, t0, time.perf_counter())
    late = loop.sent - (t0 + due)
    # the second and third requests were due during the stall: sent late,
    # and their latency counts the wait from when they were due
    assert late[1] > 0.15 and late[2] > 0.15
    assert lat[1] >= late[1] and lat[1] > 0.15
    # the last one was sent on time and answered at once
    assert late[3] < 0.1 and lat[3] < 0.1
    assert serve.percentile(np.sort(lat) * 1e3, 50) > 150


def test_a_request_never_answered_counts_to_the_end_of_the_wait():
    loop = serve.OpenLoop(None, np.zeros((1, 1)), np.array([0.0]),
                          np.array([0]))
    assert serve.latencies(loop, 10.0, 70.0)[0] == 60.0
