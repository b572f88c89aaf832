"""Per-layer metric `batch.job_overhead_s.grid`: `batch.job_overhead_s` read on the grid cell, rank 0
(moves columns_per_s.grid).  The reader is batch.job_overhead_s.py's."""

from rtbench.harness import manifest

_BASE = manifest.load_metric("batch.job_overhead_s")
UNIT, LAYER, SOURCE = _BASE.UNIT, _BASE.LAYER, _BASE.SOURCE
MOVES = "columns_per_s.grid"
read = _BASE.read
