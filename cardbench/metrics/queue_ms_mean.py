"""Admission and batching: the mean time a request waited in the server's
queue before its batch was taken (the server's ``serving.queue_ms``
histogram, its sum over its count in the stretch), in ms."""


def read(rec):
    lane = rec["lane"]
    if not lane.get("queue_n"):
        return None
    return lane["queue_ms_sum"] / lane["queue_n"]
