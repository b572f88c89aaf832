"""Captured solves on a card (sbdart_tpu_torch/ops/graph.py): a replay
equals the eager solve to the bit, NaN positions too.

Marked `cuda`; skips where torch sees no CUDA device.  On a card (where
there is no JAX, so the repo conftest is left out):

    python -m pytest tests/test_torch_graph_cuda.py -m cuda --noconftest -o addopts=''

  * Each route ops/graph.py:graph_ok admits (chip_smoke.py's solve cells
    at 512 band-columns or fewer): the first call is the eager warm-up,
    the second captures and replays on the same inputs, the third replays
    on fresh inputs against a fresh eager solve; the replays move the
    launch counters of the path's kernels.
  * Two captured calls of two keys, replayed in turns, each equal to its
    eager solve.
  * run_pipeline and run_batch (with a resume) through their captured
    solvers against the same runs with capture ruled out.
  * A route outside the rule runs eagerly and says why.
  * A replay stays equal to eager after constants past any count are
    made, and after the constant cache is emptied and its memory handed
    out again (a graph holds the constants it reads).
  * With a pool budget of no bytes, the pipeline's solver cache drops each
    captured graph at the next capture, and every run still equals eager.
  * The cyclic garbage collector is paused during a capture (a graph it
    freed there would invalidate the capture) and runs again after it.
"""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA graphs exist on a card only")
    return torch.device("cuda", 0)


def _cell(name, device, seed):
    import chip_smoke

    return chip_smoke.solve_cell(name, device, seed=seed, small=True)


def _equal(got, want):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


def _launches():
    from sbdart_tpu_torch.ops.graph import launch_counters

    return {f.__name__: f.launches for f in launch_counters()}


@pytest.mark.cuda
@pytest.mark.parametrize("name", [
    "nstr4-flux-33L", "nstr16-flux-65L", "nstr4-thermal-33L",
    "nstr4-flux-65L", "nstr4-rad-33L", "nstr16-rad-65L/256",
    "nstr8-brdf-thermal-33L", "G1", "G2", "G2-scan", "G3", "G4", "G5", "G6",
    "G7", "G8", "G8-scan", "G9"])
def test_replay_equals_eager(cuda_device, name):
    import chip_smoke
    from sbdart_tpu_torch.ops.graph import graph_ok

    path, nstr, args, kw = _cell(name, cuda_device, seed=0)
    assert graph_ok(path, nstr, torch.float32, cuda_device)
    call, inputs = chip_smoke.captured_solve(args, kw)
    want = chip_smoke.eager_solve(args, kw)
    first = call(inputs)
    assert call.graph is None
    _equal(first, want)
    before = _launches()
    got = call(inputs)
    torch.cuda.synchronize()
    assert call.graph is not None and call.replays == 1
    _equal(got, want)
    moved = {k for k, v in _launches().items() if v != before[k]}
    assert moved and moved == {f.__name__ for f, _ in call.deltas}
    _, _, f_args, f_kw = _cell(name, cuda_device, seed=1)
    fresh = chip_smoke.eager_solve(f_args, f_kw)
    got = call(chip_smoke.captured_solve(f_args, f_kw, inputs_only=True))
    torch.cuda.synchronize()
    _equal(got, fresh)


@pytest.mark.cuda
def test_two_keys_live_at_once(cuda_device):
    import chip_smoke

    calls = []
    for name in ("nstr4-flux-33L", "nstr16-flux-65L"):
        _, _, args, kw = _cell(name, cuda_device, seed=2)
        call, inputs = chip_smoke.captured_solve(args, kw)
        calls.append((call, inputs, chip_smoke.eager_solve(args, kw)))
    for _ in range(2):
        for call, inputs, want in calls:
            call(inputs)
    for _ in range(2):
        for call, inputs, want in calls:
            _equal(call(inputs), want)
    assert all(c.replays == 3 for c, _, _ in calls)


CFG4 = dict(idatm=2, iaer=1, vis=10.0, albcon=0.1, nstr=16, sza=40.0,
            wlinf=0.40, wlsup=0.70, wlinc=0.01, nzen=3, uzen=[0, 60, 120],
            nphi=2, phi=[0, 90], iout=20)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [
    dict(idatm=2, wlinf=0.25, wlsup=2.0, wlinc=0.005, sza=30.0, albcon=0.2,
         nstr=4, iout=10),
    dict(idatm=1, wlinf=4.0, wlsup=40.0, wlinc=-20.0, nstr=4, sza=95.0,
         iout=11),
    CFG4], ids=["config1", "config2", "config4-reduced"])
def test_pipeline_replays_equal_eager(cuda_device, cfg, monkeypatch):
    """Two runs through one cached solver (the first's first chunk its
    warm-up, every other chunk a replay) against a run with capture ruled
    out."""
    import chip_smoke
    from sbdart_tpu_torch import pipeline
    from sbdart_tpu_torch.config import Config
    from sbdart_tpu_torch.ops.graph import CapturedCall

    made = []

    class Recording(CapturedCall):
        def __init__(self, fn, *, capture):
            super().__init__(fn, capture=capture)
            made.append(self)

    c = Config(**cfg).validate()
    pipeline._captured_solver.cache_clear()
    monkeypatch.setattr(pipeline, "CapturedCall", Recording)
    got = pipeline.run_pipeline(c, chunk=16)
    again = pipeline.run_pipeline(c, chunk=16)
    (call,) = made
    assert call.graph is not None and call.replays == call.calls - 1
    with chip_smoke.eager_only():
        want = pipeline.run_pipeline(c, chunk=16)
    for f in ("fdir", "fdn", "fup", "dfdt", "uavg", "uu"):
        a, b, w = getattr(got, f), getattr(again, f), getattr(want, f)
        if w is None:
            assert a is None
            continue
        np.testing.assert_array_equal(a, w, err_msg=f)
        np.testing.assert_array_equal(b, w, err_msg=f)
    pipeline._captured_solver.cache_clear()


BATCH_CFG = dict(idatm=2, wlinf=1.8, wlsup=2.3, wlinc=0.05, nstr=4,
                 albcon=0.2, tcloud=[5.0, 0, 0, 0, 0],
                 zcloud=[2.0, 0, 0, 0, 0], iaer=1)


@pytest.mark.cuda
def test_run_batch_replays_equal_eager_with_resume(cuda_device, tmp_path):
    import chip_smoke
    from sbdart_tpu_torch.batch import ColumnBatch, run_batch
    from sbdart_tpu_torch.config import Config
    from sbdart_tpu_torch.kernels.blocktri_n2 import block_thomas_rt_n2

    rng = np.random.default_rng(4)
    n = 40
    batch = ColumnBatch(csza=rng.uniform(0.2, 1.0, n),
                        gas_scale=rng.uniform(0.8, 1.2, n),
                        cld_scale=rng.uniform(0.5, 1.5, n),
                        aer_scale=rng.uniform(0.5, 1.5, n),
                        albedo_scale=rng.uniform(0.5, 1.5, n))
    cfg = Config(**BATCH_CFG)
    ck = str(tmp_path / "ck")
    got = run_batch(cfg, batch, band_chunk=4, col_chunk=8, checkpoint_dir=ck)
    with chip_smoke.eager_only():
        want = run_batch(cfg, batch, band_chunk=4, col_chunk=8)
    for f in ("fdir", "fdn", "fup"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    # resume: every chunk restored launches nothing; one deleted chunk is
    # recomputed (its first call the warm-up of a new build), equal again
    block_thomas_rt_n2.launches = 0
    res = run_batch(cfg, batch, band_chunk=4, col_chunk=8, checkpoint_dir=ck)
    assert block_thomas_rt_n2.launches == 0
    (tmp_path / "ck" / "cols_16_24.npz").unlink()
    res2 = run_batch(cfg, batch, band_chunk=4, col_chunk=8, checkpoint_dir=ck)
    assert block_thomas_rt_n2.launches > 0
    for f in ("fdir", "fdn", "fup"):
        np.testing.assert_array_equal(getattr(res, f), getattr(want, f))
        np.testing.assert_array_equal(getattr(res2, f), getattr(want, f))


@pytest.mark.cuda
@pytest.mark.parametrize("name, dtype", [("G10", torch.float32),
                                         ("nstr4-flux-33L", torch.float64)])
def test_route_outside_the_rule_runs_eagerly(cuda_device, name, dtype):
    import chip_smoke
    from sbdart_tpu_torch.ops.graph import eager_reason

    path, nstr, args, kw = _cell(name, cuda_device, seed=0)
    kw = dict(kw, dtype=dtype)
    reason = eager_reason(path, nstr, dtype, cuda_device)
    assert reason
    call, inputs = chip_smoke.captured_solve(args, kw)
    assert not call.capture
    want = chip_smoke.eager_solve(args, kw)
    for _ in range(3):
        _equal(call(inputs), want)
    assert call.graph is None and call.replays == 0


@pytest.mark.cuda
def test_replay_survives_constant_churn(cuda_device):
    import chip_smoke
    from sbdart_tpu_torch.ops import graph

    _, _, args, kw = _cell("nstr4-rad-33L", cuda_device, seed=3)
    call, inputs = chip_smoke.captured_solve(args, kw)
    want = chip_smoke.eager_solve(args, kw)
    call(inputs)
    _equal(call(inputs), want)
    for i in range(2048):
        graph.const(np.full(3, float(i)), torch.float32, cuda_device)
    _equal(call(inputs), want)
    shapes = [(t.shape, t.dtype) for t in graph._consts.values()]
    graph._consts.clear()
    junk = [torch.full(s, 7, dtype=d, device=cuda_device)
            for s, d in shapes for _ in range(2)]
    _equal(call(inputs), want)
    del junk


@pytest.mark.cuda
def test_pipeline_cache_drops_graphs_past_the_pool_budget(cuda_device,
                                                          monkeypatch):
    import chip_smoke
    from sbdart_tpu_torch import pipeline
    from sbdart_tpu_torch.config import Config
    from sbdart_tpu_torch.ops import graph

    cfgs = [Config(**dict(CFG4, phi=[0, p])).validate() for p in (90, 45)]
    with chip_smoke.eager_only():
        want = [pipeline.run_pipeline(c, chunk=16) for c in cfgs]
    pipeline._captured_solver.cache_clear()
    monkeypatch.setattr(graph, "pool_budget", lambda device: 0)
    for c, w in zip(cfgs + cfgs, want + want):
        got = pipeline.run_pipeline(c, chunk=16)
        held = [e for e in pipeline._captured_solver.entries()
                if e.graph is not None]
        assert len(held) == 1 and held[0].pool_bytes > 0
        for f in ("fdir", "fdn", "fup", "dfdt", "uavg", "uu"):
            np.testing.assert_array_equal(getattr(got, f), getattr(w, f),
                                          err_msg=f)
    assert pipeline._captured_solver.cache_info().misses == 4
    pipeline._captured_solver.cache_clear()


@pytest.mark.cuda
def test_capture_pauses_cyclic_garbage_collection(cuda_device):
    import gc

    import chip_smoke
    from sbdart_tpu_torch.ops.graph import CapturedCall
    from sbdart_tpu_torch.solver.disort import solve_rte

    _, _, args, kw = _cell("nstr4-thermal-33L", cuda_device, seed=5)
    inputs = chip_smoke.captured_solve(args, kw, inputs_only=True)
    static = {k: v for k, v in kw.items() if k not in inputs}
    collecting = []

    def body(**x):
        collecting.append(gc.isenabled())
        return solve_rte(**x, **static)

    call = CapturedCall(body, capture=True)
    want = chip_smoke.eager_solve(args, kw)
    call(inputs)
    got = call(inputs)
    torch.cuda.synchronize()
    assert collecting == [True, False] and gc.isenabled()
    _equal(got, want)
