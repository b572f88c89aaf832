"""Per-layer metric `graph.capture_ms.batch` (graph; moves columns_per_s; from program_span).

Milliseconds of the traced job's `graph.warmup` and `graph.capture`
spans summed (sbdart_tpu_torch/ops/graph.py:CapturedCall: the first
band-chunk solve run eagerly, then the capture and its instantiation):
what a graph kept across `run_batch` calls would save.
"""

from rtbench.harness import spans

UNIT = "ms"
LAYER = "graph"
MOVES = "columns_per_s"
SOURCE = "program_span"
NAMES = ("graph.warmup", "graph.capture")


def read(obs):
    return spans.summed_ms(obs, NAMES)
