"""The serving executor off its CPU: 100 x (1 - thread CPU / wall) over
its ``batch:take``, ``batch:pad`` and ``batch:respond`` spans inside the
traced stretch, host work that waits on nothing but the interpreter lock
and the scheduler (the port's program spans), in %."""
from cardbench.program_spans import dur, inside


def read(rec):
    parts = [s for n in ("batch:take", "batch:pad", "batch:respond")
             for s in inside(rec, n)]
    wall = sum(dur(s) for s in parts)
    if wall <= 0:
        return None
    return 100.0 * (1.0 - sum(s["cpu_s"] for s in parts) / wall)
