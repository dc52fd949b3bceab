"""The serving executor's busy share: the part of the traced stretch its
thread spent in ``serve:batch`` spans (one a flush; the port's program
spans, cut to the stretch), in %."""
from cardbench.program_spans import dur


def read(rec):
    w = rec["window_s"]
    batches = [dict(s, start_s=max(s["start_s"], 0.0),
                    end_s=min(s["end_s"], w))
               for s in rec.get("program_spans") or []
               if s["name"] == "serve:batch"]
    if w <= 0 or not batches:
        return None
    return 100.0 * sum(max(dur(s), 0.0) for s in batches) / w
