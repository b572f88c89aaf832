"""The port's spans and counters (sbdart_tpu_torch/tracing.py) on the CPU:
off they record nothing and cost one check; the profiler or
`recording()` turns them on; parents and job ids nest; a span lies on
the profiler's clock around the operations it wraps; run_batch records
its job, its deck build and each column chunk's phases, and a resume
counts its restored chunks; `counters()` holds the kernel wrappers'
launch counts, which a CPU call leaves alone.  run_batch runs
tests/test_torch_batch.py's CFG, float64."""

import itertools
import logging
import os
import threading
import tracemalloc
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sbdart_tpu_torch import batch as batch_mod
from sbdart_tpu_torch import tracing
from sbdart_tpu_torch.batch import ColumnBatch, run_batch
from sbdart_tpu_torch.config import Config

CFG = dict(idatm=2, wlinf=0.4, wlsup=0.7, wlinc=0.05, nstr=4, albcon=0.2)
F64 = dict(dtype=torch.float64, device="cpu")
KW = dict(band_chunk=4, col_chunk=4, **F64)
CHUNKS = [(0, 4), (4, 8)]
PHASES = ("batch.restore_check", "batch.params", "batch.bands",
          "batch.collect", "batch.checkpoint")


def columns(n=8, seed=3):
    rng = np.random.default_rng(seed)
    return ColumnBatch(csza=rng.uniform(0.2, 1.0, n),
                       gas_scale=rng.uniform(0.8, 1.2, n),
                       albedo_scale=rng.uniform(0.5, 1.5, n))


@pytest.fixture(autouse=True)
def fresh():
    tracing.clear()
    yield
    tracing.clear()


def names(spans, name):
    return [s for s in spans if s.name == name]


def test_off_records_nothing_and_never_enters_record_function(
        monkeypatch, tmp_path):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered while off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    off = tracing.span("batch.params", lo=0, hi=4)
    assert tracing.span("graph.replay") is off

    def loop(n):
        for _ in itertools.repeat(None, n):
            with tracing.span("batch.params", lo=0, hi=4):
                pass

    loop(10)
    peaks = []
    for n in (1, 10000):
        tracemalloc.start()
        try:
            loop(n)
            peaks.append(tracemalloc.get_traced_memory())
        finally:
            tracemalloc.stop()
    # nothing kept, and nothing allocated that grows with the calls
    assert peaks[0][0] == peaks[1][0] == 0 and peaks[1][1] == peaks[0][1]
    run_batch(Config(**CFG), columns(), checkpoint_dir=str(tmp_path), **KW)
    assert tracing.spans() == [] and tracing.dropped() == 0
    # the counters are always on
    assert tracing.counters()["graph.eager_calls"] == 4


@pytest.mark.parametrize("how", ["profiler", "recording"])
def test_the_profiler_and_recording_turn_recording_on(how):
    with (profile(activities=[ProfilerActivity.CPU]) if how == "profiler"
          else tracing.recording()):
        with tracing.span("a", k=1):
            pass
    with tracing.span("b"):
        pass
    (s,) = tracing.spans()
    assert s.name == "a" and s.attrs == {"k": 1} and s.parent is None
    assert 0 < s.start_ns <= s.end_ns


def test_parents_and_job_ids_nest():
    seen = []

    def other_thread():
        with tracing.span("t"):
            seen.append(len(tracing.spans()) - 1)

    with tracing.recording():
        for _ in range(2):
            with tracing.span("batch.job"):
                with tracing.span("a"):
                    with tracing.span("b"):
                        th = threading.Thread(target=other_thread)
                        th.start()
                        th.join(10)
                        assert not th.is_alive()
                with tracing.span("c"):
                    pass
        with tracing.span("d"):
            pass
    got = tracing.spans()
    assert [s.name for s in got] == ["batch.job", "a", "b", "t", "c"] * 2 + [
        "d"]
    for first in (0, 5):
        job, a, b, t, c = got[first:first + 5]
        assert job.parent is None and job.job is not None
        assert (a.parent, b.parent, c.parent) == (first, first + 1, first)
        assert {a.job, b.job, c.job} == {job.job}
        # another thread's span opens under none of this thread's
        assert seen[first // 5] == first + 3
        assert t.parent is None and t.job is None
        assert job.start_ns <= a.start_ns <= b.start_ns <= b.end_ns
        assert b.end_ns <= a.end_ns <= c.start_ns <= c.end_ns <= job.end_ns
    assert got[0].job != got[5].job
    assert got[10].parent is None and got[10].job is None


def test_a_span_lies_around_the_profilers_events_of_its_work():
    a = torch.randn(128, 128, dtype=torch.float64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("matmul"):
            torch.mm(a, a)
    (s,) = tracing.spans()
    (mm,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "aten::mm"]
    start, end = mm.start_ns(), mm.start_ns() + mm.duration_ns()
    assert s.start_ns <= start < end <= s.end_ns
    # the span is also a range in the profiler's own record
    assert any(e.name() == "matmul"
               for e in prof.profiler.kineto_results.events())


def test_run_batch_records_its_job_deck_and_column_chunk_phases(tmp_path):
    with tracing.recording():
        run_batch(Config(**CFG), columns(), checkpoint_dir=str(tmp_path),
                  **KW)
    got = tracing.spans()
    (job,) = names(got, "batch.job")
    assert job.attrs == {"columns": 8, "col_chunk": 4, "band_chunk": 4}
    (deck,) = names(got, "pipeline.deck")
    assert got[deck.parent] is job
    assert all(s.job == job.job and s.end_ns is not None for s in got)
    for phase in PHASES:
        found = names(got, phase)
        assert [(s.attrs["lo"], s.attrs["hi"]) for s in found] == CHUNKS, (
            phase)
        assert all(got[s.parent] is job for s in found)
    assert not names(got, "batch.collectives")
    # each chunk's phases in order, after the deck
    order = [s for s in got if s.name in PHASES]
    assert [s.name for s in order] == list(PHASES) * 2
    assert deck.end_ns <= order[0].start_ns
    assert all(a.end_ns <= b.start_ns for a, b in zip(order, order[1:]))
    # the band chunks' solves (eager on the CPU) under batch.bands
    for bands in names(got, "batch.bands"):
        inner = [s for s in got if s.parent is not None
                 and got[s.parent] is bands]
        assert [s.name for s in inner] == ["graph.eager"] * 2


def test_a_resume_counts_restored_chunks_and_solves_only_the_rest(
        tmp_path, monkeypatch, caplog):
    cfg, b = Config(**CFG), columns()
    run_batch(cfg, b, checkpoint_dir=str(tmp_path), **KW)
    os.remove(tmp_path / "cols_4_8.npz")
    # run_batch's clock steps one second a reading: its log's rate is the
    # columns this call solved over the seconds since its loop began
    ticks = itertools.count()
    monkeypatch.setattr(batch_mod, "time", types.SimpleNamespace(
        perf_counter=lambda: float(next(ticks)), time=lambda: 0.0))
    caplog.set_level(logging.INFO, logger="sbdart_tpu_torch.batch")
    with tracing.recording():
        run_batch(cfg, b, checkpoint_dir=str(tmp_path), **KW)
    got = tracing.spans()
    assert tracing.counters()["batch.restored_chunks"] == 1
    assert [s.attrs["lo"] for s in names(got, "batch.restore_check")] == [
        0, 4]
    for phase in PHASES[1:]:
        assert [(s.attrs["lo"], s.attrs["hi"]) for s in names(got, phase)
                ] == [(4, 8)], phase
    done = [r.getMessage() for r in caplog.records
            if "done" in r.getMessage()]
    assert done == ["chunk 2/2 cols 4-8 done (4.0 cols/s)"]


def test_counters_read_the_kernel_launch_counts_live():
    """A kernel wrapper's launches are the process counter
    `kernels.<wrapper>.launches`: a wrapper call on CPU tensors runs the
    plain version and moves none of them, and a count under a name shows
    in counters() at once."""
    from sbdart_tpu_torch.kernels.blocktri import block_thomas

    rng = np.random.default_rng(0)
    arrays = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
              for s in ((3, 4, 4, 5), (3, 4, 4, 5), (3, 4, 4, 5), (3, 4, 5))]
    arrays[0] = arrays[0] + 8.0 * torch.eye(4)[None, :, :, None]
    block_thomas(*arrays)
    assert not [k for k in tracing.counters() if k.startswith("kernels.")]
    tracing.count("kernels.block_thomas.launches")
    assert tracing.counters()["kernels.block_thomas.launches"] == 1
    tracing.count("x.y", 2)
    tracing.count("x.y")
    assert tracing.counters()["x.y"] == 3


def test_the_record_keeps_the_last_spans_and_counts_the_rest(monkeypatch):
    import collections

    monkeypatch.setattr(tracing, "_records", collections.deque(maxlen=4))
    with tracing.recording():
        with tracing.span("outer"):
            for i in range(5):
                with tracing.span("inner", i=i):
                    pass
    got = tracing.spans()
    assert [s.attrs["i"] for s in got] == [1, 2, 3, 4]
    assert tracing.dropped() == 2
    # the parent was pushed out
    assert all(s.parent is None for s in got)
