"""Chrome-trace (Perfetto) export of the span event log.

The port of ``mmlspark_tpu/observability/trace.py``:
``mmlspark-tpu-torch report <events.jsonl> --trace out.trace.json`` turns
the JSON-lines log into ``trace_event``-format JSON, which Perfetto and
chrome://tracing open directly. The rules are the reference's, and so is
the output, event for event:

- spans are keyed on ``(pid, span_id)`` (span ids count per process; a
  log without ``pid`` fields falls back to pid 0);
- nesting comes from the recorded ``parent_id``: each root span chain is
  laid on one track (``tid``), chosen greedily so roots that do not
  overlap share a track;
- every span is a ``B``/``E`` pair in microseconds from the log's
  earliest start; children are clamped inside their parent and siblings
  sequentialized where rounding makes them overlap, so every track nests;
- plain ``event`` records (stalls, sync points, fault hits) and
  ``serving`` records are instant (``i``) marks on track 0.

Pure data in, data out (no torch): this is the record of a run, not the
card's timeline, which ``utils/profiling.trace`` captures.
"""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

from mmlspark_tpu_torch.observability.report import load_events

_EVENTS_TID = 0          # instant marks live on tid 0; span tracks start at 1


def _span_key(e: Dict[str, Any]) -> Tuple[int, int]:
    return int(e.get("pid") or 0), int(e["span_id"])


def build_trace(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Event dicts -> ``{"traceEvents": [...], "displayTimeUnit": "ms"}``.

    Only spans with a ``span_id`` and plain events with a ``ts`` are
    consumed; anything else (metrics, malformed records) is skipped.
    """
    spans = [e for e in events
             if e.get("type") == "span" and e.get("span_id") is not None]
    instants = [e for e in events
                if e.get("type") in ("event", "serving")
                and e.get("ts") is not None]

    # intervals: (pid, span_id) -> [start, end]; tree: parent -> children
    by_key: Dict[Tuple[int, int], Dict[str, Any]] = {}
    for s in spans:
        by_key[_span_key(s)] = s
    children: Dict[Optional[Tuple[int, int]], List[Tuple[int, int]]] = \
        defaultdict(list)
    for key, s in by_key.items():
        parent = (key[0], int(s["parent_id"])) \
            if s.get("parent_id") else None
        if parent is not None and parent not in by_key:
            parent = None          # orphan (partial capture): treat as root
        children[parent].append(key)

    t0s = [float(s.get("start", s.get("ts", 0.0))) for s in spans]
    t0s += [float(e["ts"]) for e in instants]
    t0 = min(t0s) if t0s else 0.0

    def us(t: float) -> float:
        return round((t - t0) * 1e6, 3)

    out: List[Dict[str, Any]] = []
    tracks_per_pid: Dict[int, List[float]] = defaultdict(list)

    def emit_span(key: Tuple[int, int], lo: float, hi: float,
                  tid: int) -> None:
        """Emit one span's B/E (clamped into [lo, hi]) and recurse."""
        s = by_key[key]
        start = float(s.get("start", s.get("ts", 0.0)))
        end = start + float(s.get("dur_s", 0.0))
        start = min(max(start, lo), hi)
        end = max(min(end, hi), start)
        pid = key[0]
        args: Dict[str, Any] = {"span_id": key[1], "depth": s.get("depth")}
        if s.get("error"):
            args["error"] = s["error"]
        if isinstance(s.get("attrs"), dict):
            args.update(s["attrs"])
        name = str(s.get("name", "?"))
        out.append({"ph": "B", "name": name,
                    "cat": name.split(":", 1)[0],
                    "ts": us(start), "pid": pid, "tid": tid, "args": args})
        cursor = start
        kids = sorted(children.get(key, ()),
                      key=lambda k: float(by_key[k].get("start", 0.0)))
        for kid in kids:
            k_start = max(cursor,
                          float(by_key[kid].get("start", start)))
            emit_span(kid, k_start, end, tid)
            cursor = max(cursor, k_start
                         + float(by_key[kid].get("dur_s", 0.0)))
        out.append({"ph": "E", "ts": us(end), "pid": pid, "tid": tid})

    # per process: lay roots onto tracks (greedy first-fit on end time)
    roots_by_pid: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    for key in children[None]:
        roots_by_pid[key[0]].append(key)
    for pid, roots in sorted(roots_by_pid.items()):
        roots.sort(key=lambda k: float(by_key[k].get("start", 0.0)))
        tracks = tracks_per_pid[pid]
        for key in roots:
            s = by_key[key]
            start = float(s.get("start", s.get("ts", 0.0)))
            end = start + float(s.get("dur_s", 0.0))
            tid = None
            for i, busy_until in enumerate(tracks):
                if busy_until <= start:
                    tid = i + 1
                    break
            if tid is None:
                tracks.append(end)
                tid = len(tracks)
            else:
                tracks[tid - 1] = end
            emit_span(key, start, end, tid)

    # instant marks: incidents/events on their own track per pid
    pids = set(tracks_per_pid) | {int(e.get("pid") or 0) for e in instants}
    default_pid = min(tracks_per_pid) if tracks_per_pid else 0
    for e in instants:
        pid = int(e.get("pid") or default_pid)
        skip = {"ts", "type", "name", "pid"}
        args = {k: v for k, v in e.items() if k not in skip}
        name = str(e.get("name", "?"))
        if e.get("type") == "serving":
            name = f"serving.{name}"
        out.append({"ph": "i", "s": "t", "name": name,
                    "ts": us(float(e["ts"])), "pid": pid,
                    "tid": _EVENTS_TID,
                    "args": json.loads(json.dumps(args, default=str))})

    # metadata: readable process/track names in the Perfetto UI
    meta: List[Dict[str, Any]] = []
    for pid in sorted(pids):
        meta.append({"ph": "M", "name": "process_name", "pid": pid,
                     "tid": 0, "args": {"name": f"mmlspark-tpu pid {pid}"}})
        meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                     "tid": _EVENTS_TID, "args": {"name": "events"}})
        for i in range(len(tracks_per_pid.get(pid, ()))):
            meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                         "tid": i + 1, "args": {"name": f"spans-{i + 1}"}})

    return {"traceEvents": meta + out, "displayTimeUnit": "ms",
            "otherData": {"source": "mmlspark-tpu events.jsonl",
                          "t0_wall_s": t0,
                          "spans": len(spans), "events": len(instants)}}


def validate_trace(trace: Dict[str, Any]) -> List[str]:
    """Schema check for an exported trace; returns problems (empty =
    valid). Enforced: every ``B`` is closed by an ``E`` on the same
    ``(pid, tid)`` (LIFO), and timestamps are monotone non-decreasing per
    track in emission order."""
    problems: List[str] = []
    evs = trace.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    open_stacks: Dict[Tuple[int, int], List[str]] = defaultdict(list)
    last_ts: Dict[Tuple[int, int], float] = {}
    for i, e in enumerate(evs):
        ph = e.get("ph")
        if ph not in ("B", "E", "i", "M", "X", "C"):
            problems.append(f"event {i}: unknown ph {ph!r}")
            continue
        if ph == "M":
            continue
        track = (e.get("pid"), e.get("tid"))
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i}: bad ts {ts!r}")
            continue
        if ph in ("B", "E") and ts < last_ts.get(track, float("-inf")):
            problems.append(
                f"event {i}: ts {ts} < previous {last_ts[track]} on "
                f"track {track}")
        if ph in ("B", "E"):
            last_ts[track] = float(ts)
        if ph == "B":
            if not e.get("name"):
                problems.append(f"event {i}: B without name")
            open_stacks[track].append(str(e.get("name", "")))
        elif ph == "E":
            if not open_stacks[track]:
                problems.append(f"event {i}: E without open B on "
                                f"track {track}")
            else:
                open_stacks[track].pop()
    for track, stack in open_stacks.items():
        if stack:
            problems.append(f"track {track}: {len(stack)} unclosed B "
                            f"({stack[-1]!r} innermost)")
    return problems


def export_trace(events_path: str, out_path: str) -> Dict[str, Any]:
    """Read an events.jsonl, write the Chrome-trace JSON to ``out_path``,
    and return summary stats (spans/events/tracks exported)."""
    trace = build_trace(load_events(events_path))
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(trace, f)
    other = trace.get("otherData", {})
    tracks = len({(e.get("pid"), e.get("tid"))
                  for e in trace["traceEvents"] if e.get("ph") == "B"})
    return {"out": out_path, "spans": other.get("spans", 0),
            "events": other.get("events", 0), "tracks": tracks}
