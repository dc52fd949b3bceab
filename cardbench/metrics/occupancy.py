"""Batch occupancy: requests scored over the rows of the bucket graphs
replayed for them in the stretch, in %."""


def read(rec):
    lane = rec["lane"]
    rows = sum(b * r for b, r in lane.get("replays", {}).items())
    if not rows:
        return None
    return 100.0 * lane["images"] / rows
