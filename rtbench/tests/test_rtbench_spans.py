"""The readers of the program's spans (metrics/pipeline.deck_ms.*,
graph.capture_ms.*, batch.boundary_idle_ms*, through harness/spans.py)
on a hand-made trace and a hand-made span record."""

from __future__ import annotations

import sys

import pytest

from rtbench.harness import manifest
from rtbench.harness.observe import Observation
from rtbench.harness.trace import ANNOTATION, Trace

LO, HI = 1_000_000, 2_000_000          # the traced span (ns)
BOUNDARY = ("batch.restore_check", "batch.params", "batch.collectives",
            "batch.collect", "batch.checkpoint")
PAIRS = {"pipeline.deck_ms.batch": "pipeline.deck_ms.grid",
         "graph.capture_ms.batch": "graph.capture_ms.grid",
         "batch.boundary_idle_ms": "batch.boundary_idle_ms.grid"}


def span(name, t0, t1):
    from sbdart_tpu_torch.tracing import Span

    return Span(name, t0, t1, None, 0, {})


def trace(device):
    tr = Trace()
    tr.spans = [(ANNOTATION + "traced", LO, HI)]
    tr.device = sorted(device, key=lambda e: e[1])
    return tr


def observation(device, chunks=2):
    return Observation(shapes={}, trace=trace(device),
                       column_chunks_traced=chunks)


def record(monkeypatch, spans):
    from sbdart_tpu_torch import tracing

    monkeypatch.setattr(tracing, "spans", lambda: list(spans))


def read(name, obs):
    return manifest.load_metric(name).read(obs)


@pytest.mark.parametrize("phase", BOUNDARY)
def test_boundary_idle_counts_gaps_inside_each_boundary_span(monkeypatch,
                                                             phase):
    # device busy but for two gaps: [1.2, 1.3] ms under the boundary
    # span, [1.6, 1.8] ms under batch.bands (not a boundary)
    device = [("k", LO, 1_200_000), ("k", 1_300_000, 1_600_000),
              ("k", 1_800_000, HI)]
    record(monkeypatch, [span("batch.job", LO, HI),
                         span(phase, 1_150_000, 1_350_000),
                         span("batch.bands", 1_350_000, 1_900_000)])
    obs = observation(device, chunks=2)
    # 0.1 ms of idle over two column chunks
    assert read("batch.boundary_idle_ms", obs) == pytest.approx(0.05)


def test_a_gap_outside_the_boundary_spans_is_not_counted(monkeypatch):
    device = [("k", LO, 1_200_000), ("k", 1_300_000, HI)]
    record(monkeypatch, [span("batch.job", LO, HI),
                         span("pipeline.deck", 1_190_000, 1_310_000),
                         span("batch.checkpoint", 1_260_000, 1_300_000)])
    # the gap's midpoint, 1.25 ms, lies under the deck, not the checkpoint
    assert read("batch.boundary_idle_ms", observation(device)) == 0.0
    assert read("pipeline.deck_ms.batch", observation(device)) == (
        pytest.approx(0.12))


def test_spans_outside_the_traced_span_are_left_out(monkeypatch):
    device = [("k", LO, 1_200_000), ("k", 1_300_000, HI)]
    record(monkeypatch, [
        span("pipeline.deck", 100, 900_000),             # before it
        span("graph.warmup", 1_900_000, 2_100_000),      # across its end
        span("graph.capture", 2_500_000, 2_600_000),     # after it
        span("batch.collect", 500_000, 1_400_000),       # across its start
        span("graph.capture", 1_400_000, None),          # still open
    ])
    obs = observation(device)
    for name in ("pipeline.deck_ms.batch", "graph.capture_ms.batch",
                 "batch.boundary_idle_ms"):
        assert read(name, obs) is None, name
    record(monkeypatch, [span("graph.warmup", 1_100_000, 1_150_000),
                         span("graph.capture", 1_200_000, 1_300_000),
                         span("graph.warmup", 2_500_000, 2_600_000)])
    assert read("graph.capture_ms.batch", obs) == pytest.approx(0.15)


def test_no_number_without_device_operations_or_a_record(monkeypatch):
    record(monkeypatch, [span("pipeline.deck", 1_100_000, 1_200_000),
                         span("batch.collect", 1_100_000, 1_200_000)])
    for name in list(PAIRS) + list(PAIRS.values()):
        assert read(name, observation([])) is None, name
        assert read(name, Observation(shapes={})) is None, name
    # a checkout whose program keeps no spans
    import sbdart_tpu_torch

    monkeypatch.delattr(sbdart_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "sbdart_tpu_torch.tracing", None)
    device = [("k", LO, 1_200_000), ("k", 1_300_000, HI)]
    for name in list(PAIRS) + list(PAIRS.values()):
        assert read(name, observation(device)) is None, name


@pytest.mark.parametrize("base", list(PAIRS))
def test_the_grid_twins_read_as_their_base(monkeypatch, base):
    device = [("k", LO, 1_200_000), ("k", 1_300_000, HI)]
    record(monkeypatch, [span("pipeline.deck", 1_000_000, 1_100_000),
                         span("graph.warmup", 1_100_000, 1_150_000),
                         span("graph.capture", 1_150_000, 1_200_000),
                         span("batch.collectives", 1_200_000, 1_300_000)])
    obs = observation(device)
    twin = manifest.load_metric(PAIRS[base])
    assert twin.MOVES == "columns_per_s.grid"
    assert twin.read(obs) == read(base, obs) is not None
    assert read(base, obs) == pytest.approx(
        {"pipeline.deck_ms.batch": 0.1, "graph.capture_ms.batch": 0.1,
         "batch.boundary_idle_ms": 0.05}[base])


def test_the_readers_take_the_programs_own_record():
    """Spans the program records while the profiler runs, read back over
    a trace with those bounds."""
    import torch

    from sbdart_tpu_torch import tracing

    tracing.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("pipeline.deck"):
            pass
    (s,) = tracing.spans()
    tr = trace([("k", s.start_ns - 10, s.start_ns - 5)])
    tr.spans = [(ANNOTATION + "traced", s.start_ns - 20, s.end_ns + 20)]
    obs = Observation(shapes={}, trace=tr)
    assert read("pipeline.deck_ms.batch", obs) == (s.end_ns
                                                   - s.start_ns) / 1e6
    tracing.clear()
