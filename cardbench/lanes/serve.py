"""An image-scoring service under an open loop: independent clients send
one uint8 image each at seeded arrival times through ``Server.submit_async``.

Traffic keys: ``image`` [H, W, C]; ``pool_images``; ``buckets``;
``max_wait_ms``; ``queue_depth``; ``phases``, a cycle of [length_s,
rate_per_s] (``gen.arrivals``); ``warm_seconds`` of the same traffic
before the window; ``cut_output_layers``. End-to-end: ``p95_ms``, the 95th
percentile (nearest rank) over every request due in the window, each timed
from when it was due; a refused or failed request counts as answered only
when the wait for answers ended. ``correct``: every answer against the
float32 reference of its image (``row_rel_err``)."""
import contextlib
import functools
import math
import threading
import time

import numpy as np
import torch

from cardbench import gen, weights
from cardbench.compare import row_rel_err
from cardbench.harness import free_device, within
from cardbench.lanes import now, peak_bytes, sync, trace_start
from cardbench.lanes.featurize import stand_in
from cardbench.reference.drive import pool_outputs

MODEL = "model"
# how long answers are waited for once the window has closed
ANSWER_WAIT_S = 60.0


class OpenLoop:
    """Sends request ``i`` at ``t0 + due[i]`` (at once when late) and
    notes when it was sent and answered. An answer is copied into one
    array as it comes and its future let go, as an independent client's
    would be: the clients' bookkeeping shares the server's process and
    must not swell the heap that the server's collections walk."""

    def __init__(self, srv, rows: np.ndarray, due: np.ndarray,
                 idx: np.ndarray, span=None):
        self.srv, self.rows, self.due, self.idx = srv, rows, due, idx
        self.span = span or (lambda name: contextlib.nullcontext())
        n = len(due)
        self.sent = np.full(n, np.nan)
        self.done = np.full(n, np.nan)
        self.ok = np.zeros(n, bool)
        self.out = None
        self.refused = 0
        self.pending = 0
        self._settled = threading.Condition()

    def _answered(self, i, fut):
        try:
            row = fut.result()
        except Exception:    # counted as failed
            row = None
        t = now()
        with self._settled:
            if row is not None:
                row = np.asarray(row).reshape(-1)
                if self.out is None:
                    self.out = np.empty((len(self.due), row.size), row.dtype)
                self.out[i] = row
                self.ok[i] = True
                self.done[i] = t
            self.pending -= 1
            self._settled.notify_all()

    def send(self, t0: float, at_time=None):
        """Send every request; ``at_time(t)`` is called before each send
        with the seconds since ``t0`` (the traced stretch's switch)."""
        from mmlspark_tpu_torch.serve.server import ServeError
        for i, d in enumerate(self.due):
            wait = t0 + d - now()
            if wait > 0:
                with self.span("sleep"):
                    time.sleep(wait)
            if at_time is not None:
                at_time(now() - t0)
            self.sent[i] = now()
            try:
                with self.span("submit"):
                    fut = self.srv.submit_async(MODEL, self.rows[self.idx[i]])
            except ServeError:
                self.refused += 1
                continue
            with self._settled:
                self.pending += 1
            fut.add_done_callback(functools.partial(self._answered, i))

    def wait(self, until: float):
        """Until every request sent is settled, or ``until``."""
        with self._settled:
            self._settled.wait_for(lambda: self.pending == 0,
                                   timeout=max(0.0, until - now()))

    def answers(self):
        ok = np.flatnonzero(self.ok)
        if not len(ok):
            return [], ok
        return [(self.idx[ok], self.out[ok])], ok


def latencies(loop: OpenLoop, t0: float, waited: float) -> np.ndarray:
    """Each request's seconds from when it was due (``t0 + due``) to its
    answer; one never answered, refused or failed, to ``waited``, when
    the wait for answers ended."""
    done = np.where(loop.ok, loop.done, waited)
    return done - (t0 + loop.due)


def percentile(sorted_ms: np.ndarray, q: float) -> float:
    """Nearest-rank ``q``-th percentile of sorted values."""
    n = len(sorted_ms)
    return float(sorted_ms[max(0, math.ceil(q / 100 * n) - 1)]) if n \
        else float("nan")


def scoring_model(cfg, tr, params):
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    h, w, c = tr["image"]
    s = cfg["image_size"]
    tm = TorchModel(inputCol="image", outputCol="features",
                    outputNodeName="pool" if tr["cut_output_layers"] == 1
                    else "", miniBatchSize=max(tr["buckets"]),
                    devicePreprocess={"srcShape": [h, w, c], "resize": [s, s]},
                    computeDtype=cfg["compute_dtype"])
    return tm.set_model(cfg["architecture"], params=params, **cfg["arch_args"])


def _counters(srv, entry):
    from mmlspark_tpu_torch.observability import metrics
    q = metrics.histogram("serving.queue_ms")
    return {"replays": {key[0][0]: p.replays
                        for key, p in entry.built_programs().items()},
            "queue_sum": q.sum, "queue_n": q.count, "t": now()}


def run(ctx):
    from mmlspark_tpu_torch.serve import Server
    from mmlspark_tpu_torch.utils import config
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    dtype = getattr(torch, cfg["compute_dtype"])
    params = weights.make(cfg, ctx.seed, dev, round_to=dtype)
    ctx.mark("weights")
    pool = gen.image_pool(tr["pool_images"], tr["image"], ctx.seed, dev)
    rows = pool.reshape(len(pool), -1)
    ctx.mark("inputs")
    buckets = tuple(tr["buckets"])
    # the server's queue and compute histograms, read in the traced run
    config.set("observability.metrics", bool(ctx.trace))
    srv = Server({MODEL: scoring_model(cfg, tr, params)},
                 max_batch=max(buckets), buckets=buckets,
                 max_wait_ms=tr["max_wait_ms"], queue_depth=tr["queue_depth"])
    try:
        entry = srv.registry.get(MODEL)
        for b in buckets:
            entry.program_for(b, rows[:b])
        ctx.mark("captures")
        warm_due = gen.arrivals(tr["phases"], tr["warm_seconds"],
                                weights.sub_seed(ctx.seed, "warm"))
        warm = OpenLoop(srv, rows, warm_due,
                        gen.pool_sequence(len(warm_due), len(rows), ctx.seed))
        t = now()
        warm.send(t)
        warm.wait(t + tr["warm_seconds"] + ANSWER_WAIT_S)
        ctx.tracer.warm()
        sync(dev)
        ctx.mark("warm")

        due = gen.arrivals(tr["phases"], ctx.seconds, ctx.seed)
        loop = OpenLoop(srv, rows, due,
                        gen.pool_sequence(len(due), len(rows), ctx.seed),
                        ctx.tracer.span)
        t_on = trace_start(ctx)
        marks = {}

        def at_time(t):
            if ctx.trace and "before" not in marks and t >= t_on:
                marks["before"] = _counters(srv, entry)
                ctx.tracer.start()

        t0 = ctx.window_opens()
        loop.send(t0, at_time)
        if "before" in marks:
            marks["record"] = ctx.tracer.stop()
            marks["after"] = _counters(srv, entry)
        close = t0 + ctx.seconds
        loop.wait(max(close, now()) + ANSWER_WAIT_S)
        waited = now()
        peak = peak_bytes(dev)
        stats = srv.stats()
        replays = {key[0][0]: p.replays
                   for key, p in entry.built_programs().items()}
    finally:
        srv.close()
        config.set("observability.metrics", False)
    del srv, entry
    free_device()

    answered = ~np.isnan(loop.done)
    lat_ms = np.sort(latencies(loop, t0, waited) * 1e3)
    n = len(lat_ms)
    p95 = percentile(lat_ms, 95)
    answers, ok = loop.answers()
    failed = n - len(ok)
    layer = "pool" if tr["cut_output_layers"] == 1 else "logits"
    used = np.unique(loop.idx[ok])
    ref = pool_outputs(cfg, params, pool, used, layer, dev)
    answers = stand_in(ctx, answers, params, pool, used, layer)
    err, bad = row_rel_err(answers, ref)
    limit = ctx.limits["row_rel_err"]
    record = marks.get("record")
    if record is not None:
        b, a = marks["before"], marks["after"]
        traced = {k: a["replays"][k] - b["replays"].get(k, 0)
                  for k in a["replays"]}
        # answered inside the stretch, by the benchmark's own clock
        served = int(((loop.done >= b["t"]) & (loop.done <= a["t"])).sum())
        record["lane"] = {
            "images": served, "replays": traced, "src": tr["image"],
            "train": False, "out_bytes": dtype.itemsize, "over_busy": True,
            "queue_ms_sum": a["queue_sum"] - b["queue_sum"],
            "queue_n": a["queue_n"] - b["queue_n"]}
    late = (loop.sent - (t0 + due)) * 1e3
    lat_q = latencies(loop, t0, waited) * 1e3
    quarter = np.minimum((due / ctx.seconds * 4).astype(int), 3)
    return {"e2e": {"p95_ms": p95}, "record": record,
            "correct": within(err, limit) and bad == 0 and n > 0,
            "compared": {"row_rel_err": (err, limit)},
            "attempted": n, "failed": failed + bad,
            "memory_peak_bytes": peak,
            "info": {"requests": n, "refused": loop.refused,
                     "offered_per_s": n / ctx.seconds,
                     "answered_per_s": float(answered.sum() / (
                         np.nanmax(loop.done) - t0)) if answered.any()
                     else 0.0,
                     "p50_ms": float(lat_ms[n // 2]) if n else None,
                     "late_ms_p50": float(np.nanpercentile(late, 50)),
                     "late_ms_p99": float(np.nanpercentile(late, 99)),
                     "late_ms_max": float(np.nanmax(late)),
                     "last_answer_after_close_s": float(
                         np.nanmax(loop.done) - close) if answered.any()
                     else None,
                     "p95_ms_by_quarter": [
                         percentile(np.sort(lat_q[quarter == i]), 95)
                         for i in range(4)],
                     "replays_by_bucket": replays,
                     "server": {k: stats[k] for k in
                                ("completed", "shed", "expired", "failed")}}}

