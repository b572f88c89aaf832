"""Per-layer metric `graph.replayed_share.batch` (graph; moves columns_per_s; from device_trace).

The profiler's count of cudaGraphLaunch calls over the traced span,
divided by the chunk solves the cell's shapes imply there: the share of
solves that ran as one replayed CUDA graph.
"""

UNIT = "share"
LAYER = "graph"
MOVES = "columns_per_s"
SOURCE = "device_trace"


def read(obs):
    tr = obs.trace
    if tr is None or not obs.solves_traced:
        return None
    n = tr.runtime.get("cudaGraphLaunch", 0)
    return n / obs.solves_traced if n else None
