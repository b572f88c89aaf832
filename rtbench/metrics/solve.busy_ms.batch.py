"""Per-layer metric `solve.busy_ms.batch` (solve; moves columns_per_s; from device_trace).

Device busy milliseconds (the union over streams of every device
operation's interval, from torch.profiler) per band-chunk solve of the traced span;
the count of band-chunk solves comes from the cell's shapes.
"""

UNIT = "ms"
LAYER = "solve"
MOVES = "columns_per_s"
SOURCE = "device_trace"


def per_solve(obs, skip=None):
    """Busy ms per solve, leaving out the operations `skip` accepts."""
    tr = obs.trace
    if tr is None or not obs.solves_traced:
        return None
    busy = tr.busy_ns(*tr.bounds(), skip=skip)
    return busy / obs.solves_traced / 1e6 if busy > 0 else None


def read(obs):
    return per_solve(obs)
