"""A kernel wrapper's launch count as the port's process counters hold it
(sbdart_tpu_torch/tracing.py: `kernels.<wrapper>.launches`)."""

from sbdart_tpu_torch import tracing


def launches(wrapper) -> int:
    """`wrapper`'s launches so far: its counter, 0 before its first
    launch."""
    return tracing.counters().get(f"kernels.{wrapper.__name__}.launches", 0)
