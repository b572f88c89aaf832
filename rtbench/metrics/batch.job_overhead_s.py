"""Per-layer metric `batch.job_overhead_s` (batch; moves columns_per_s; from program_span).

Seconds a job pays once, from `run_batch`'s own log records
(sbdart_tpu_torch.batch, "chunk i/n ... done"): the time from the call
to the first column chunk's record less the median interval between
the later records (the deck build, the first band chunk run eagerly
and the capture), averaged over the window's jobs.  Only the records'
timestamps are read.
"""

UNIT = "s"
LAYER = "batch"
MOVES = "columns_per_s"
SOURCE = "program_span"


def read(obs):
    vals = [j["overhead_s"] for j in obs.jobs if j["overhead_s"] is not None]
    return sum(vals) / len(vals) if vals else None
