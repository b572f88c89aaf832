"""Per-layer metric `pipeline.deck_ms.grid`: `pipeline.deck_ms.batch` read on the grid cell, rank 0
(moves columns_per_s.grid).  The reader is pipeline.deck_ms.batch.py's."""

from rtbench.harness import manifest

_BASE = manifest.load_metric("pipeline.deck_ms.batch")
UNIT, LAYER, SOURCE = _BASE.UNIT, _BASE.LAYER, _BASE.SOURCE
MOVES = "columns_per_s.grid"
read = _BASE.read
