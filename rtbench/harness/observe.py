"""What a run hands the per-layer readers (metrics/<name>.py)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Observation:
    shapes: dict                  # one solve's shapes (harness/work.py)
    trace: object = None          # harness/trace.Trace, or None
    solves_traced: int = 0        # solves the traced span ran, by shape
    column_chunks_traced: int = 0
    jobs: list = dataclasses.field(default_factory=list)
    collectives: bool = False     # the cell runs on a process grid
    busy_ns_ranks: list = None    # each rank's traced busy ns (a grid)
