"""Per-layer metric `grid.collective_ms.grid` (grid; moves columns_per_s.grid; from device_trace).

Device milliseconds of the NCCL kernels (the band all-reduce, the data
all-gather and the checkpoint decision's all-reduce) per column chunk
of the traced job, on rank 0.
"""

UNIT = "ms"
LAYER = "grid"
MOVES = "columns_per_s.grid"
SOURCE = "device_trace"


def read(obs):
    tr = obs.trace
    if tr is None or not obs.collectives or not obs.column_chunks_traced:
        return None
    ns = tr.device_ns(lambda name: "nccl" in name.lower())
    return ns / obs.column_chunks_traced / 1e6 if ns else None
