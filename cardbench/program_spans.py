"""The port's own spans in a traced stretch: the bridge from its collector
(``mmlspark_tpu_torch.observability.spans``) to the stretch's record, the
idle gaps named by them, and what the per-layer readers of program spans
share.

The port stamps its spans on ``time.time_ns()``, the clock the profiler
stamps device activity with, so they sit on the stretch's seconds as the
benchmark's spans do. A port without the collector gives nothing: ``start``
returns False, and the readers return None on a record without
``program_spans``.

Wired into a traced run by ``start()`` beside ``Tracer.start`` and
``stop(rec)`` beside ``Tracer.stop``; ``idle_gaps_top`` in place of
``tracing.idle_gaps_top``."""
from typing import Dict, Iterable, List

from cardbench.tracing import idle_gaps_top as bench_gaps_top


def _collector():
    from mmlspark_tpu_torch.observability import spans
    return spans if hasattr(spans, "collect_start") else None


def start() -> bool:
    """Turn the port's collector on; False when the port has none."""
    spans = _collector()
    if spans is None:
        return False
    spans.collect_start()
    return True


def stop(rec: Dict) -> None:
    """Turn the collector off and put what it kept into
    ``rec["program_spans"]``: dicts of ``name``, ``span_id``,
    ``parent_id``, ``thread``, ``start_s``/``end_s`` from the stretch's
    start, ``cpu_s`` (the thread's CPU time inside the span) and
    ``attrs``; ``rec["program_spans_dropped"]``, past the collector's
    bound. Nothing when the port has no collector."""
    spans = _collector()
    if spans is None:
        return
    got, dropped = spans.collect_stop()
    w0 = rec["window_ns"][0]
    rec["program_spans"] = [
        {"name": s["name"], "span_id": s["span_id"],
         "parent_id": s["parent_id"], "thread": s["thread"],
         "start_s": (s["start_ns"] - w0) / 1e9,
         "end_s": (s["end_ns"] - w0) / 1e9, "cpu_s": s["cpu_ns"] / 1e9,
         "attrs": s["attrs"]} for s in got]
    rec["program_spans_dropped"] = dropped


def idle_gaps_top(rec: Dict, k: int = 10) -> List[list]:
    """``tracing.idle_gaps_top``'s gaps, each named by the program span
    (on any thread) whose own time, less its children's, covers the most
    of it: the stage the host was in while the device waited. The span
    open when a gap began is, on a drained queue, the fetch that waited
    for it (a featurize frame's 0.4-s gaps began in ``score:fetch`` and
    were mostly the next frame's prep and stack). A gap no program span
    overlaps keeps the benchmark's name (``idle`` when neither was
    open)."""
    bench = bench_gaps_top(rec, k)
    spans = rec.get("program_spans")
    if not spans:
        return bench
    w0, w1 = rec["window_ns"]
    gaps, prev = [], w0
    for s, e in rec["busy_intervals"]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    gaps.sort(key=lambda g: g[0] - g[1])   # as tracing.idle_gaps_top
    out = []
    for (g0, g1), named in zip(gaps[:k], bench):
        a, b = (g0 - w0) / 1e9, (g1 - w0) / 1e9
        own = {}
        for s in spans:
            over = min(b, s["end_s"]) - max(a, s["start_s"])
            if over > 0:
                own[s["span_id"]] = [s["name"], own.get(
                    s["span_id"], [None, 0.0])[1] + over]
                if s["parent_id"] is not None:
                    own.setdefault(s["parent_id"], [None, 0.0])[1] -= over
        own = [v for v in own.values() if v[0] is not None]
        out.append([max(own, key=lambda v: v[1])[0], named[1]] if own
                   else named)
    return out


def inside(rec: Dict, name: str) -> List[Dict]:
    """The program spans named ``name`` that began and ended inside the
    traced stretch (a span cut by its edge lacks some of its children)."""
    w = rec["window_s"]
    return [s for s in rec.get("program_spans") or []
            if s["name"] == name and 0 <= s["start_s"] and s["end_s"] <= w]


def children(rec: Dict) -> Dict:
    """The program spans by their parent's id."""
    by_parent: Dict = {}
    for s in rec.get("program_spans") or []:
        by_parent.setdefault(s["parent_id"], []).append(s)
    return by_parent


def descendants(by_parent: Dict, root: Dict,
                names: Iterable[str]) -> List[Dict]:
    """The spans under ``root`` (at any depth, ``by_parent`` from
    :func:`children`) whose name is in ``names``."""
    names = set(names)
    out, todo = [], [root["span_id"]]
    while todo:
        for s in by_parent.get(todo.pop(), []):
            todo.append(s["span_id"])
            if s["name"] in names:
                out.append(s)
    return out


def dur(s: Dict) -> float:
    return s["end_s"] - s["start_s"]


def mean_ms_under(rec: Dict, root: str, names: Iterable[str]):
    """The mean, over the ``root`` spans inside the stretch, of the
    seconds their ``names`` descendants took, in ms; None without one."""
    roots = inside(rec, root)
    if not roots:
        return None
    by_parent = children(rec)
    names = list(names)
    total = sum(dur(s) for r in roots
                for s in descendants(by_parent, r, names))
    return 1e3 * total / len(roots)
