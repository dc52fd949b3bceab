"""Collectives: the device time of the NCCL kernels a training step runs
(the gradient all-reduce, the loss's mean), in ms a step, averaged over
the ranks."""


def read(rec):
    lane = rec["lane"]
    per_rank = [s for s in lane.get("nccl_s") or [] if s is not None]
    if not lane.get("steps") or not per_rank or not any(per_rank):
        return None
    return 1e3 * sum(per_rank) / len(per_rank) / lane["steps"]
