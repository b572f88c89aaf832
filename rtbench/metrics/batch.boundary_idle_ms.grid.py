"""Per-layer metric `batch.boundary_idle_ms.grid`: `batch.boundary_idle_ms` read on the grid cell, rank 0
(moves columns_per_s.grid).  The reader is batch.boundary_idle_ms.py's."""

from rtbench.harness import manifest

_BASE = manifest.load_metric("batch.boundary_idle_ms")
UNIT, LAYER, SOURCE = _BASE.UNIT, _BASE.LAYER, _BASE.SOURCE
MOVES = "columns_per_s.grid"
read = _BASE.read
