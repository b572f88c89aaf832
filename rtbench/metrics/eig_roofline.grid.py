"""Per-layer metric `eig_roofline.grid`: `eig_roofline.batch` read on the grid cell, rank 0
(moves columns_per_s.grid).  The reader is eig_roofline.batch.py's."""

from rtbench.harness import manifest

_BASE = manifest.load_metric("eig_roofline.batch")
UNIT, LAYER, SOURCE = _BASE.UNIT, _BASE.LAYER, _BASE.SOURCE
MOVES = "columns_per_s.grid"
read = _BASE.read
OPERATION, PATTERNS = _BASE.OPERATION, _BASE.PATTERNS
