"""Per-layer metric `device.idle_share.batch` (device; moves columns_per_s; from device_trace).

1 - busy / wall over the traced span: the share of the span in which
no device operation ran (torch.profiler's timeline).
"""

UNIT = "share"
LAYER = "device"
MOVES = "columns_per_s"
SOURCE = "device_trace"


def idle(obs, skip=None):
    """The idle share, counting the operations `skip` accepts as idle."""
    tr = obs.trace
    if tr is None:
        return None
    lo, hi = tr.bounds()
    busy = tr.busy_ns(lo, hi, skip=skip)
    return 1.0 - busy / (hi - lo) if busy > 0 and hi > lo else None


def read(obs):
    return idle(obs)
