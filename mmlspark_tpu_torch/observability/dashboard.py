"""``mmlspark-tpu-torch top``: the operator's one-glance fleet view.

The port's copy of ``mmlspark_tpu/observability/dashboard.py``, over the
port's ``FleetScraper``, ``SloEngine`` and goodput meter; a frame's text
equals the reference's for the same snapshot.

A live terminal dashboard over :class:`FleetScraper` + :class:`SloEngine`
— per-replica ready/draining, queue depth, QPS, p50/p99, shed rate, SLO
burn, HBM occupancy, the open-loop workload line when one is live
(offered vs delivered QPS, goodput under deadline, un-clipped
arrival-time p99 — a GoodputMeter passed as ``workload=`` or scraped
``workload.*`` gauges), and (when a generate lane is live) the decode line:
prefix-cache hit rate, CoW copies, speculation acceptance, int8 arena
savings — for watching a ``Fleet.rollout`` or a chaos run in real time. Deliberately curses-free: each frame is a plain string and
the live loop just re-homes the cursor with ANSI ``ESC[H ESC[J`` before
printing, so it works over ssh, inside tmux, and in CI logs alike.
``--once`` (the :meth:`TopDashboard.run` ``once`` flag) prints a single
frame and exits — the form tests and scripts use. Clock and output
stream are injectable.

Rates (QPS, shed rate) are derived from the delta between consecutive
scrapes, so the first frame shows totals only.
"""
from __future__ import annotations

import sys
import threading
import time as _time
from typing import Any, Callable, Dict, List, Optional

from mmlspark_tpu_torch.observability import events
from mmlspark_tpu_torch.observability.aggregate import FleetScraper
from mmlspark_tpu_torch.observability.slo import SloEngine

_CLEAR = "\x1b[H\x1b[J"


def format_bytes(n: float) -> str:
    n = float(n)
    for unit in ("B", "KB", "MB", "GB"):
        if abs(n) < 1000.0 or unit == "GB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1000.0
    return f"{n:.1f}GB"  # pragma: no cover - loop always returns


def _rate(cur: float, prev: Optional[float], dt: float) -> Optional[float]:
    if prev is None or dt <= 0 or cur < prev:
        return None
    return (cur - prev) / dt


class TopDashboard:
    """Render loop over one scraper (and optionally one SLO engine).

    ``tick()`` = one scrape -> one SLO evaluation -> one frame string;
    ``run(once=True)`` prints a single frame, ``run()`` redraws every
    ``interval_s`` until ``stop()`` / KeyboardInterrupt.
    """

    def __init__(self, scraper: FleetScraper,
                 engine: Optional[SloEngine] = None, *,
                 autopilot=None, supervisor=None, workload=None,
                 clock: Optional[Callable[[], float]] = None,
                 out=None, interval_s: float = 2.0):
        self.scraper = scraper
        self.engine = engine
        # anything with an Autopilot-shaped stats() dict; the panel shows
        # the live decision stream next to the signals that drive it
        self.autopilot = autopilot
        # anything with a Supervisor-shaped stats() dict; the panel shows
        # desired vs live plus the elasticity in flight
        self.supervisor = supervisor
        # anything with a GoodputMeter-shaped result() dict (an open-loop
        # driver in this process); without one, the line falls back to
        # scraped ``workload.*`` gauges when a replica exports them
        self.workload = workload
        self.clock = clock or events.wall
        self.out = out if out is not None else sys.stdout
        self.interval_s = float(interval_s)
        self._prev: Optional[Dict[str, Any]] = None
        self._prev_t: Optional[float] = None
        self._stop = threading.Event()

    # -- one frame ---------------------------------------------------------
    def tick(self) -> str:
        snap = self.scraper.scrape()
        status = None
        if self.engine is not None:
            status = self.engine.observe(self.scraper.slo_sample(snap))
        frame = self.render(snap, status)
        self._prev = snap
        self._prev_t = float(snap["ts"])
        return frame

    def render(self, snap: Dict[str, Any],
               slo_status: Optional[List[Dict[str, Any]]] = None) -> str:
        now = float(snap["ts"])
        dt = (now - self._prev_t) if self._prev_t is not None else 0.0
        prev_fleet = (self._prev or {}).get("fleet", {})
        fleet = snap.get("fleet", {})
        reps = snap.get("replicas", {})
        ready = sum(1 for r in reps.values() if r.get("ready"))
        lines = [
            f"mmlspark-tpu top  t={now:.1f}  replicas {ready}/{len(reps)} "
            f"ready  scrape {snap.get('scrape_ms', 0.0):.1f}ms"]

        qps = _rate(fleet.get("admitted", 0.0),
                    prev_fleet.get("admitted"), dt)
        shed_rate = _rate(fleet.get("shed", 0.0), prev_fleet.get("shed"), dt)
        parts = [f"admitted {fleet.get('admitted', 0.0):.0f}",
                 f"shed {fleet.get('shed', 0.0):.0f}",
                 f"expired {fleet.get('expired', 0.0):.0f}",
                 f"failovers {fleet.get('failovers', 0.0):.0f}",
                 f"p50 {fleet.get('p50_ms', 0.0):.1f}ms",
                 f"p99 {fleet.get('p99_ms', 0.0):.1f}ms"]
        if qps is not None:
            parts.insert(0, f"qps {qps:.1f}")
        if shed_rate is not None:
            parts.append(f"shed/s {shed_rate:.1f}")
        lines.append("fleet    " + "  ".join(parts))

        # open-loop workload truth: offered vs delivered and the
        # un-clipped arrival-time p99 against the deadline — from a live
        # GoodputMeter when the driver runs in-process, else from the
        # ``workload.*`` gauges a replica exported
        wl: Optional[Dict[str, Any]] = None
        if self.workload is not None:
            wl = self.workload.result()
        elif any(k.startswith("workload.") for k in fleet):
            wl = {k.split(".", 1)[1]: v for k, v in fleet.items()
                  if k.startswith("workload.")}
        if wl:
            parts = [
                f"offered {float(wl.get('offered', 0)):.0f}",
                f"delivered {float(wl.get('delivered', 0)):.0f}",
                f"goodput {100.0 * float(wl.get('goodput', 0.0)):.1f}%",
                f"arrival p99 {float(wl.get('arrival_p99_ms', 0.0)):.1f}ms"
                f" (deadline {float(wl.get('deadline_ms', 0.0)):.0f}ms)"]
            shed_n = float(wl.get("shed", 0))
            exp_n = float(wl.get("expired", 0))
            if shed_n or exp_n:
                parts.append(f"shed {shed_n:.0f}  expired {exp_n:.0f}")
            lines.append("workload " + "  ".join(parts))

        # generative decode lane: fleet totals hold summed
        # ``generate.<model>.<key>`` stats; match on exact key depth so
        # the lane's prefix_hits is not conflated with kv.prefix_hits
        def _gsum(*tail: str) -> float:
            want = list(tail)
            return sum(float(v) for k, v in fleet.items()
                       if isinstance(v, (int, float))
                       and k.split(".")[:1] == ["generate"]
                       and k.split(".")[2:] == want)

        if any(k.startswith("generate.") for k in fleet):
            hits, misses = _gsum("prefix_hits"), _gsum("prefix_misses")
            prop, acc = _gsum("spec_proposed"), _gsum("spec_accepted")
            saved = (_gsum("kv", "unquantized_arena_bytes")
                     - _gsum("kv", "arena_bytes"))
            parts = [
                f"prefix {100.0 * hits / max(1.0, hits + misses):.1f}%",
                f"cow {_gsum('cow_copies'):.0f}",
                f"spec {100.0 * acc / prop:.1f}%" if prop else "spec -"]
            if _gsum("kv", "quantized"):
                parts.append(f"int8 saved {format_bytes(max(0.0, saved))}")
            lines.append("decode   " + "  ".join(parts))

        # prefix-affinity routing: how the router split traffic (prefix /
        # session / plain WRR) and what each replica is advertising — the
        # live view of "N replicas, one cache"
        aff = snap.get("affinity")
        if aff and aff.get("routes"):
            parts = [
                f"routes {aff['routes']:.0f}",
                f"prefix {aff.get('routes_prefix', 0):.0f}",
                f"session {aff.get('routes_session', 0):.0f}",
                f"wrr {aff.get('routes_wrr', 0):.0f}",
                f"share {100.0 * aff.get('affinity_route_share', 0.0):.1f}%"]
            adv = aff.get("advertised") or []
            if adv:
                parts.append("adv " + ", ".join(
                    f"{d['replica']}:{d['max_depth']}" for d in adv[:6]))
            lines.append("affinity " + "  ".join(parts))

        for st in slo_status or []:
            flag = "BREACH" if st["breaching"] else (
                "burn" if st["burning"] else "ok")
            lines.append(
                f"slo      {st['objective']:<14} fast {st['burn_fast']:>7.2f}"
                f"  slow {st['burn_slow']:>7.2f}  [{flag}]")

        if self.autopilot is not None:
            ap = self.autopilot.stats()
            parts = [f"ticks {ap.get('ticks', 0)}",
                     f"actions {ap.get('actions', 0)}",
                     f"suppressed {ap.get('suppressed', 0)}"]
            if ap.get("errors"):
                parts.append(f"errors {ap['errors']}")
            recent = [d for d in ap.get("recent", ())
                      if not d.get("suppressed")][-3:]
            if recent:
                parts.append("last " + ", ".join(
                    d["action"] + (f"({d['target']})" if d.get("target")
                                   else "")
                    for d in recent))
            lines.append("autopilot " + "  ".join(parts))

        if self.supervisor is not None:
            sp = self.supervisor.stats()
            desired = sp.get("desired_replicas", 0)
            live = sp.get("live_replicas", 0)
            parts = [f"desired {desired}",
                     f"live {live}" + ("" if live == desired else " (!)")]
            if sp.get("spawns_in_flight"):
                parts.append(f"spawning {sp['spawns_in_flight']}")
            if sp.get("retiring"):
                parts.append(f"retiring {sp['retiring']}")
            h = sp.get("spawn_to_ready_ms", {})
            if h.get("count"):
                parts.append(f"spawn->ready p50 {h['p50']:.0f}ms "
                             f"p99 {h['p99']:.0f}ms")
            lines.append("workers  " + "  ".join(parts))

        mem = snap.get("memory", {})
        kinds = mem.get("by_kind", {})
        lines.append(
            "hbm      total " + format_bytes(mem.get("total_bytes", 0))
            + "  hwm " + format_bytes(mem.get("high_watermark_bytes", 0))
            + "".join(f"  {k} {format_bytes(v)}"
                      for k, v in sorted(kinds.items())))
        for model, mk in sorted(mem.get("by_model", {}).items()):
            lines.append(
                f"         {model}: "
                + "  ".join(f"{k} {format_bytes(v)}"
                            for k, v in sorted(mk.items())))

        name_w = max([10] + [len(n) + 2 for n in reps])
        header = (f"{'replica':<{name_w}}{'state':<10}{'ready':<7}{'queue':<7}"
                  f"{'inflight':<10}{'admitted':<10}{'shed':<7}"
                  f"{'p50ms':<9}{'p99ms':<9}{'breaker':<10}")
        lines.append(header)
        lines.append("-" * len(header))
        prev_reps = (self._prev or {}).get("replicas", {})
        for name, r in sorted(reps.items()):
            s = r.get("stats", {})
            prev_s = prev_reps.get(name, {}).get("stats", {})
            rqps = _rate(s.get("admitted", 0.0),
                         prev_s.get("admitted"), dt)
            admitted = (f"{rqps:.1f}/s" if rqps is not None
                        else f"{s.get('admitted', 0.0):.0f}")
            err = r.get("error")
            state = r.get("state", "?") if not err else err[:18]
            lines.append(
                f"{name:<{name_w}}{state:<10}"
                f"{'yes' if r.get('ready') else 'NO':<7}"
                f"{s.get('queue_depth', 0.0):<7.0f}"
                f"{s.get('inflight', 0.0):<10.0f}"
                f"{admitted:<10}"
                f"{s.get('shed', 0.0):<7.0f}"
                f"{s.get('p50_ms', 0.0):<9.2f}"
                f"{s.get('p99_ms', 0.0):<9.2f}"
                f"{r.get('breaker', '?'):<10}")
        return "\n".join(lines) + "\n"

    # -- loop --------------------------------------------------------------
    def run(self, once: bool = False,
            sleep: Optional[Callable[[float], None]] = None) -> None:
        """Print frames until stopped. ``once=True`` prints exactly one
        frame with no ANSI clear (CI/test friendly)."""
        if once:
            self.out.write(self.tick())
            self.out.flush()
            return
        sleep = sleep or _time.sleep
        try:
            while not self._stop.is_set():
                frame = self.tick()
                self.out.write(_CLEAR + frame)
                self.out.flush()
                sleep(self.interval_s)
        except KeyboardInterrupt:  # pragma: no cover - interactive only
            pass

    def stop(self) -> None:
        self._stop.set()
