"""Spans and counters of the port: where the batch, its deck build and the
captured solves spend the host's time, on the clock torch.profiler stamps
its events with.

    with tracing.recording():          # or under torch.profiler.profile
        run_batch(cfg, batch)
    tracing.spans()                    # [Span(name, start_ns, end_ns, ...)]
    tracing.counters()                 # {"graph.replays": ..., ...}

`span(name, **attrs)` records while torch's profiler runs or inside
`recording()`, and nowhere else: off, it costs one check and returns a
shared no-op context.  On, it reads `time.time_ns()` (the Unix-epoch
nanoseconds torch.profiler's events carry, so a span lies over the
profiler's host and device timelines) and opens
`torch.profiler.record_function(name)`, so every span also shows in a
profiler export (chrome trace, Perfetto) beside the kernels.  A record
holds the index of the enclosing open span of its thread in `spans()`'s
list (`parent`) and the id of the enclosing `batch.job` span (`job`, the
same for every span of one `run_batch` call).  The last MAXLEN spans are
kept; `dropped()` counts the ones pushed out.

`count(name, n)` adds to a process counter, always on; `counters()`
reads them.  Every kernel wrapper counts its launches in
`kernels.<wrapper>.launches` (a name appears at its first launch), and a
captured graph's replay adds what its capture counted
(ops/graph.py:CapturedCall).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch

MAXLEN = 65536
JOB = "batch.job"

Span = collections.namedtuple("Span", "name start_ns end_ns parent job attrs")

_profiling = torch.autograd._profiler_enabled
_lock = threading.Lock()
_local = threading.local()
_records: collections.deque = collections.deque(maxlen=MAXLEN)
_opened = 0           # spans recorded since the last clear()
_recording = 0        # open recording() blocks
_counts: dict = {}


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    """A recorded span: [name, start_ns, end_ns, parent id, job id, attrs,
    id] in the shared record, filled as the span opens and closes."""

    __slots__ = ("rec", "range", "stack")

    def __init__(self, name: str, attrs: dict):
        self.rec = [name, None, None, None, None, attrs, None]

    def __enter__(self):
        global _opened
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        rec = self.rec
        if stack:
            rec[3] = stack[-1][6]
            rec[4] = stack[-1][4]
        with _lock:
            rec[6] = _opened
            _opened += 1
            _records.append(rec)
        if rec[0] == JOB:
            rec[4] = rec[6]
        stack.append(rec)
        self.stack = stack
        rec[1] = time.time_ns()
        self.range = torch.profiler.record_function(rec[0])
        self.range.__enter__()
        return None

    def __exit__(self, *exc):
        try:
            self.range.__exit__(*exc)
        finally:
            self.rec[2] = time.time_ns()
            self.stack.pop()
        return False


def span(name: str, **attrs):
    """A context that records `name` with `attrs` while recording is on
    (the module docstring), and does nothing otherwise."""
    if not (_recording or _profiling()):
        return _OFF
    return _On(name, attrs)


@contextlib.contextmanager
def recording():
    """Record spans inside the block without torch's profiler."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def spans() -> list:
    """Every kept span in the order opened; a span still open has
    end_ns None; `parent` indexes this list (None at the top, or where
    the parent was pushed out)."""
    with _lock:
        recs = [tuple(r) for r in _records]
    if not recs:
        return []
    base = recs[0][6]
    return [Span(name, t0, t1,
                 None if parent is None or parent < base else parent - base,
                 job, attrs)
            for name, t0, t1, parent, job, attrs, _ in recs]


def dropped() -> int:
    """Spans pushed out of the record since the last clear()."""
    with _lock:
        return _opened - len(_records)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the process counter `name`."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def counters() -> dict:
    """The process counters."""
    with _lock:
        return dict(_counts)


def clear() -> None:
    """Forget every span and process counter."""
    global _opened
    with _lock:
        _records.clear()
        _opened = 0
        _counts.clear()
