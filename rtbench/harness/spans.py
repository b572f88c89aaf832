"""The program's own spans (sbdart_tpu_torch/tracing.py) over a traced
run, for the readers whose source is `program_span`.

The program stamps its spans with time.time_ns(), the clock of
torch.profiler's events, and records them while the profiler runs, so
the spans of the traced job lie over `Trace.device` and `Trace.gaps()`.
A reader sees this process's record only: on a grid, rank 0's.  Where
the program keeps no record (a checkout without the module) or the trace
holds no device operation, every reduction here gives None.
"""

from __future__ import annotations


def program_spans(obs) -> list | None:
    """(name, start_ns, end_ns) of each closed program span inside the
    traced span, or None."""
    tr = obs.trace
    if tr is None or not tr.device:
        return None
    try:
        from sbdart_tpu_torch import tracing
    except ImportError:
        return None
    lo, hi = tr.bounds()
    return [(s[0], s[1], s[2]) for s in tracing.spans()
            if s[2] is not None and lo <= s[1] and s[2] <= hi]


def summed_ms(obs, names) -> float | None:
    """Milliseconds of the traced spans named in `names`, summed; None
    where there is none."""
    found = [t1 - t0 for name, t0, t1 in program_spans(obs) or ()
             if name in names]
    return sum(found) / 1e6 if found else None


def idle_ns_under(obs, names) -> int | None:
    """Nanoseconds of the traced span's device-idle gaps whose midpoint
    lies inside a program span named in `names`; None without spans."""
    spans = program_spans(obs)
    if not spans:
        return None
    under = [(t0, t1) for name, t0, t1 in spans if name in names]
    total = 0
    for g0, g1 in obs.trace.gaps():
        mid = (g0 + g1) // 2
        if any(t0 <= mid <= t1 for t0, t1 in under):
            total += g1 - g0
    return total
