"""The lanes: the general drivers of the port that traffic files name.

Each ``run(ctx)`` makes its inputs and weights from the seed, warms up the
shapes its traffic uses, measures for ``ctx.seconds`` (profiling a steady
stretch when ``ctx.trace``), then, after the window and the read of the
device's peak memory, frees the program's state and holds what the timed
path produced against the plain reference. It returns ``e2e`` (its
end-to-end numbers), ``record`` (the traced stretch, for the readers),
``correct``, ``compared`` ({name: (value, limit)}), ``attempted``,
``failed``, ``memory_peak_bytes`` and ``info``."""
import time

import torch


def peak_bytes(device: torch.device) -> int:
    """This process's peak of allocated device memory (0 off a card)."""
    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(torch.cuda.current_device()))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def trace_start(ctx) -> float:
    """Where the traced stretch begins, in seconds from the window's
    start: its last ``trace_seconds`` (of the traffic file; at most half
    the window). Stopping the profiler holds the interpreter for a second
    or two while it collects the trace, so the stretch ends with the
    window, where that stall delays no request still to be sent."""
    return ctx.seconds - min(ctx.traffic["trace_seconds"], 0.5 * ctx.seconds)


def now() -> float:
    return time.perf_counter()
