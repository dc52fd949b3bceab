"""Arrival-time-truth serving measurement: goodput under deadline.

The port's copy of ``mmlspark_tpu/observability/goodput.py``.

The companion to :mod:`mmlspark_tpu_torch.testing.loadgen` — the generator
decides WHEN every request should arrive; this module decides what the
system's answer was worth. The rules that make the numbers honest:

- **Latency is measured from the INTENDED arrival time**, never from a
  throttled send or a retry's re-enqueue. A client that couldn't send
  because the system was wedged is exactly the sample a closed-loop
  driver omits (coordinated omission); here it shows up as queueing
  delay, because the request's clock started when it was supposed to.
- **Goodput** is the fraction of OFFERED requests answered within the
  deadline. Shed, expired, and deadline-busting completions all count
  against it — a system that sheds its way to a pretty p99 has low
  goodput, not low latency.
- **Percentiles are over completions only** and explicitly UN-clipped:
  a completion may exceed the deadline by any amount and is recorded at
  its real value. The shed/expired mass is reported beside them, never
  folded into the percentile (that would either clip at the deadline —
  the blind spot this replaces — or invent latencies for requests that
  never finished).
- **Time-bucketed series**: per-bucket offered/delivered counts and
  arrival-to-response p99 with the worst request's trace_id as an
  exemplar, so "the p99 was bad" comes with WHEN and WHICH.

Results export through the existing events/metrics registry
(:meth:`GoodputMeter.export`) so ``mmlspark-tpu-torch report`` and ``top``
render the workload section without new plumbing.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from mmlspark_tpu_torch.observability import events
from mmlspark_tpu_torch.observability import metrics as _metrics
from mmlspark_tpu_torch.observability.metrics import nearest_rank


class GoodputMeter:
    """Offered / delivered / shed / expired accounting over one run.

    Feed it intended arrival times (:meth:`offer`) and outcomes
    (:meth:`complete` / :meth:`shed` / :meth:`expire`), all on ONE clock
    (wall or virtual — the meter never reads a clock itself);
    :meth:`result` folds them into the workload verdict."""

    def __init__(self, *, deadline_s: float, bucket_s: float = 30.0):
        if deadline_s <= 0 or bucket_s <= 0:
            raise ValueError("deadline_s and bucket_s must be positive")
        self.deadline_s = float(deadline_s)
        self.bucket_s = float(bucket_s)
        self._arrivals: Dict[str, float] = {}
        self._done: List[Tuple[str, float, float]] = []   # id, t_arr, t_done
        self._shed: List[Tuple[str, float]] = []          # id, t_arr
        self._expired: List[Tuple[str, float]] = []

    # -- recording ---------------------------------------------------------
    def offer(self, trace_id: str, t: float) -> None:
        """Request ``trace_id`` was INTENDED to arrive at ``t``."""
        self._arrivals[trace_id] = float(t)

    def _arrival_of(self, trace_id: str) -> float:
        try:
            return self._arrivals[trace_id]
        except KeyError:
            raise KeyError(f"complete/shed/expire before offer: "
                           f"{trace_id!r}") from None

    def complete(self, trace_id: str, t: float) -> float:
        """Request answered at ``t``; returns its arrival-to-response
        latency in seconds (from the intended arrival, not any send)."""
        t_arr = self._arrival_of(trace_id)
        self._done.append((trace_id, t_arr, float(t)))
        return float(t) - t_arr

    def shed(self, trace_id: str) -> None:
        self._shed.append((trace_id, self._arrival_of(trace_id)))

    def expire(self, trace_id: str) -> None:
        self._expired.append((trace_id, self._arrival_of(trace_id)))

    # -- the verdict -------------------------------------------------------
    def result(self) -> Dict[str, Any]:
        offered = len(self._arrivals)
        delivered = len(self._done)
        shed = len(self._shed)
        expired = len(self._expired)
        lats_ms = sorted((td - ta) * 1e3 for _, ta, td in self._done)
        within = sum(1 for v in lats_ms if v <= self.deadline_s * 1e3)
        times = list(self._arrivals.values())
        t0 = min(times) if times else 0.0
        t_end = max([t0] + [td for _, _, td in self._done]
                    + [ta for ta in times])
        span = max(t_end - t0, 1e-9)
        res: Dict[str, Any] = {
            "offered": offered, "delivered": delivered,
            "shed": shed, "expired": expired,
            "unresolved": offered - delivered - shed - expired,
            "deadline_ms": self.deadline_s * 1e3,
            "goodput": round(within / offered, 4) if offered else 0.0,
            "offered_qps": round(offered / span, 4),
            "delivered_qps": round(delivered / span, 4),
            "arrival_p50_ms": round(nearest_rank(lats_ms, 50), 3),
            "arrival_p99_ms": round(nearest_rank(lats_ms, 99), 3),
            "arrival_max_ms": round(lats_ms[-1], 3) if lats_ms else 0.0,
        }
        res["buckets"] = self._buckets(t0)
        worst = max(res["buckets"], key=lambda b: b["p99_ms"], default=None)
        if worst is not None:
            res["worst_bucket"] = worst
        return res

    def _buckets(self, t0: float) -> List[Dict[str, Any]]:
        by_bucket: Dict[int, Dict[str, Any]] = {}

        def slot(t_arr: float) -> Dict[str, Any]:
            i = int((t_arr - t0) / self.bucket_s)
            return by_bucket.setdefault(i, {
                "t0": t0 + i * self.bucket_s, "offered": 0,
                "delivered": 0, "shed": 0, "lats": [], "worst": None})

        for t_arr in self._arrivals.values():
            slot(t_arr)["offered"] += 1
        for trace_id, t_arr, t_done in self._done:
            b = slot(t_arr)
            b["delivered"] += 1
            lat = (t_done - t_arr) * 1e3
            b["lats"].append(lat)
            if b["worst"] is None or lat > b["worst"][1]:
                b["worst"] = (trace_id, lat)
        for _, t_arr in self._shed + self._expired:
            slot(t_arr)["shed"] += 1
        out = []
        for i in sorted(by_bucket):
            b = by_bucket[i]
            lats = sorted(b.pop("lats"))
            worst = b.pop("worst")
            b["p99_ms"] = round(nearest_rank(lats, 99), 3)
            if worst is not None:
                b["trace_id"] = worst[0]
            out.append(b)
        return out

    # -- export ------------------------------------------------------------
    def export(self, *, lane: str = "") -> Dict[str, Any]:
        """Push the verdict into the event log (``workload.summary``) and
        the metrics registry (``workload.*`` gauges) so ``report`` and
        ``top`` render it; returns the verdict dict."""
        res = self.result()
        if events.recording_enabled():
            fields = {k: v for k, v in res.items() if k != "buckets"}
            events.emit("workload", "summary", lane=lane, **fields)
        if _metrics.metrics_enabled():
            for key in ("offered", "delivered", "shed", "expired",
                        "goodput", "offered_qps", "delivered_qps",
                        "arrival_p99_ms", "deadline_ms"):
                _metrics.gauge(f"workload.{key}").set(float(res[key]))
            worst = res.get("worst_bucket")
            if worst:
                _metrics.gauge("workload.worst_bucket_p99_ms").set(
                    float(worst["p99_ms"]))
        return res
