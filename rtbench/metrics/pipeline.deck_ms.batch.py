"""Per-layer metric `pipeline.deck_ms.batch` (pipeline; moves columns_per_s; from program_span).

Milliseconds of the traced job's `pipeline.deck` span
(sbdart_tpu_torch/batch.py:build_batch_fn): the host set-up from the
atmosphere's profile to the band tables on the card, which every
`run_batch` call pays once.
"""

from rtbench.harness import spans

UNIT = "ms"
LAYER = "pipeline"
MOVES = "columns_per_s"
SOURCE = "program_span"
NAMES = ("pipeline.deck",)


def read(obs):
    return spans.summed_ms(obs, NAMES)
