"""Per-layer metric `batch.boundary_idle_ms` (batch; moves columns_per_s; from program_span).

Device-idle milliseconds per column chunk at the column chunks'
boundaries: the traced span's idle gaps (no device operation running)
whose midpoint lies inside one of the program's boundary spans
(sbdart_tpu_torch/batch.py: the checkpoint's restore check, the
parameters' copy to the card, the grid's collectives, the wait for the
results and the checkpoint write), over the column chunks of the traced
job.
"""

from rtbench.harness import spans

UNIT = "ms"
LAYER = "batch"
MOVES = "columns_per_s"
SOURCE = "program_span"
NAMES = ("batch.restore_check", "batch.params", "batch.collectives",
         "batch.collect", "batch.checkpoint")


def read(obs):
    if not obs.column_chunks_traced:
        return None
    ns = spans.idle_ns_under(obs, NAMES)
    return None if ns is None else ns / obs.column_chunks_traced / 1e6
