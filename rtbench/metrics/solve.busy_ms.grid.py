"""Per-layer metric `solve.busy_ms.grid` (solve; moves columns_per_s.grid;
from device_trace): `solve.busy_ms.batch` read on the grid cell, rank 0,
with the NCCL kernels left out of the busy union (they spin on the card
while they wait for the slowest rank; `grid.collective_ms.grid` reports
them)."""

from rtbench.harness import manifest

_BASE = manifest.load_metric("solve.busy_ms.batch")
UNIT, LAYER, SOURCE = _BASE.UNIT, _BASE.LAYER, _BASE.SOURCE
MOVES = "columns_per_s.grid"


def collective(name):
    return "nccl" in name.lower()


def read(obs):
    return _BASE.per_solve(obs, skip=collective)
