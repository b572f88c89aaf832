"""Per-layer metric `graph.replayed_share.grid`: `graph.replayed_share.batch` read on the grid cell, rank 0
(moves columns_per_s.grid).  The reader is graph.replayed_share.batch.py's."""

from rtbench.harness import manifest

_BASE = manifest.load_metric("graph.replayed_share.batch")
UNIT, LAYER, SOURCE = _BASE.UNIT, _BASE.LAYER, _BASE.SOURCE
MOVES = "columns_per_s.grid"
read = _BASE.read
