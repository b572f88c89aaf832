"""Per-layer metric `graph.capture_ms.grid`: `graph.capture_ms.batch` read on the grid cell, rank 0
(moves columns_per_s.grid).  The reader is graph.capture_ms.batch.py's."""

from rtbench.harness import manifest

_BASE = manifest.load_metric("graph.capture_ms.batch")
UNIT, LAYER, SOURCE = _BASE.UNIT, _BASE.LAYER, _BASE.SOURCE
MOVES = "columns_per_s.grid"
read = _BASE.read
