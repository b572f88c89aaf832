"""The Planck kernel (csrc/planck_band.cu) against its plain torch version
(kernels/planck.py:planck_band_plain) on a card, to the bit.

Marked `cuda`; skips where torch sees no CUDA device.  On a card (where
there is no JAX, so the repo conftest is left out):

    python -m pytest tests/test_torch_planck_cuda.py -m cuda --noconftest -o addopts=''

The kernel rounds as ATen's CUDA kernels round the plain version, so the
two are held to equal bit patterns, NaN positions included, at:

  * config 5's band-chunk shapes as the batch hands them to solve_rte:
    the level field [1024, 32, 3, 33] from stride-0 expanded views of a
    [1, 32, 1, 33] temperature and [1, 32, 1] band edges, with the 1e-4 K
    temperature of the solar bands, and the emission shape [1024, 32, 3];
  * x = c2 nu / T just below, exactly at and just above the series switch
    at 1; T at, under and far under the 1e-6 K clamp, 0 and negative;
  * NaN and infinite band edges and temperatures; an empty broadcast;
    non-contiguous inputs (a transpose, a step slice, an offset view);
  * a replayed CapturedCall against the eager call.

A band-chunk flux solve with Planck launches the kernel three times
(eager or captured) and a solar-only solve none.
"""

import pytest
import torch

from launch_counts import launches


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on a card")
    return torch.device("cuda", 0)


def _same_bits(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    keep = ~nan
    assert torch.equal(got[keep].view(torch.int32),
                       want[keep].view(torch.int32))


def _check(lo, hi, t):
    from sbdart_tpu_torch.kernels.planck import planck_band, planck_band_plain

    before = launches(planck_band)
    got = planck_band(lo, hi, t, torch.float32)
    want = planck_band_plain(lo, hi, t, torch.float32)
    torch.cuda.synchronize()
    _same_bits(got, want)
    return got, launches(planck_band) - before


def _c5_chunk(device, **kw):
    """A c5 band chunk's Planck inputs as the batch hands them to
    solve_rte (chip_smoke.c5_planck_chunk)."""
    import chip_smoke

    return chip_smoke.c5_planck_chunk(device, **kw)


@pytest.mark.cuda
def test_c5_level_and_emission_shapes(cuda_device):
    lo, hi, temper, thermal = _c5_chunk(cuda_device)
    assert temper.stride() == (0, 33, 0, 1)
    level, n = _check(lo[..., None], hi[..., None], temper)
    assert level.shape == (1024, 32, 3, 33) and n == 1
    assert torch.isfinite(level).all() and (level > 0).any()
    btemp = torch.where(thermal, 290.0, 1e-4)
    btemp_eff = torch.where(btemp > 0, btemp, temper[..., -1])
    emis, n = _check(lo, hi, btemp_eff)
    assert emis.shape == (1024, 32, 3) and n == 1
    ttemp_eff = torch.where(torch.zeros_like(btemp) > 0, btemp,
                            temper[..., 0])
    _check(lo, hi, ttemp_eff)


@pytest.mark.cuda
def test_series_switch_both_sides_and_at_one(cuda_device):
    from sbdart_tpu_torch.constants import C2_RADIATION

    t = torch.linspace(150.0, 330.0, 64, device=cuda_device)
    c2 = torch.tensor(C2_RADIATION, dtype=torch.float32, device=cuda_device)
    # wvn * c2 / t == 1 exactly where t is the float32 product wvn * c2
    wvn = torch.linspace(100.0, 230.0, 64, device=cuda_device)
    t_at_one = wvn * c2
    assert torch.equal(wvn * c2 / t_at_one, torch.ones_like(wvn))
    lo = torch.stack([wvn, wvn * 0.5, wvn])
    hi = torch.stack([wvn * 2.0, wvn, torch.nextafter(wvn, wvn + 1)])
    _check(lo, hi, t_at_one.expand(3, -1))
    # x swept across the switch, a few ulps each side
    x = torch.linspace(0.9, 1.1, 4097, device=cuda_device)
    xs = torch.cat([x, torch.nextafter(torch.ones(8, device=cuda_device),
                                       torch.full((8,), 2.0,
                                                  device=cuda_device)),
                    torch.nextafter(torch.ones(8, device=cuda_device),
                                    torch.zeros(8, device=cuda_device))])
    tt = t[:1].expand(xs.shape)
    _check(xs * tt / c2, (xs + 0.5) * tt / c2, tt)
    _check(0.5 * xs * tt / c2, xs * tt / c2, tt)


@pytest.mark.cuda
def test_clamped_dummy_and_non_finite_temperatures(cuda_device):
    t = torch.tensor([1e-6, 9.9e-7, 1e-30, 0.0, -0.0, -5.0, 1e-4, 1e-5,
                      250.0, float("nan"), float("inf"), float("-inf")],
                     device=cuda_device)
    lo = torch.tensor([10.0, 800.0, 2500.0], device=cuda_device)[:, None]
    _check(lo, lo + 20.0, t)


@pytest.mark.cuda
def test_non_finite_band_edges(cuda_device):
    nan, inf = float("nan"), float("inf")
    lo = torch.tensor([nan, 500.0, -inf, inf, 0.0, -100.0, 800.0],
                      device=cuda_device)
    hi = torch.tensor([600.0, nan, 700.0, inf, inf, 0.0, 820.0],
                      device=cuda_device)
    t = torch.tensor([[250.0], [1e-4], [nan]], device=cuda_device)
    _check(lo, hi, t)


@pytest.mark.cuda
def test_empty_broadcast(cuda_device):
    lo = torch.empty((0, 3), device=cuda_device)
    got, n = _check(lo, lo + 1.0, torch.full((1, 3), 250.0,
                                              device=cuda_device))
    assert got.shape == (0, 3) and n == 0


@pytest.mark.cuda
def test_non_contiguous_inputs(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    base = 10.0 + 3000.0 * torch.rand((40, 70), generator=gen,
                                      device=cuda_device)
    lo = base.t()                                 # [70, 40], transposed
    wide = 25.0 + 3000.0 * torch.rand((70, 80), generator=gen,
                                      device=cuda_device)
    hi = wide[:, ::2]                              # [70, 40], column step 2
    temps = 150.0 + 180.0 * torch.rand((3, 70, 90), generator=gen,
                                       device=cuda_device)
    t = temps[1, :, 5:45]                          # offset, row stride 90
    assert not any(v.is_contiguous() for v in (lo, hi, t))
    _check(lo, hi, t)
    _check(lo[None, ::3], hi[::3], temps[:, ::3, 10:50])


@pytest.mark.cuda
def test_python_numbers_join_the_card_and_float64_is_refused(cuda_device):
    """Python numbers join a CUDA temperature on its card; float64 on the
    card is refused (the plain version runs only on CPU tensors)."""
    from sbdart_tpu_torch.kernels.planck import planck_band

    t = torch.tensor([250.0, 288.0], device=cuda_device)
    _check(800.0, 900.0, t)
    before = launches(planck_band)
    with pytest.raises(TypeError, match="float32-only"):
        planck_band(800.0, 900.0, t.double())
    with pytest.raises(TypeError, match="float32-only"):
        planck_band(800.0, 900.0, t)        # dtype defaults to float64
    assert launches(planck_band) == before


@pytest.mark.cuda
def test_replay_equals_eager(cuda_device):
    from sbdart_tpu_torch.kernels.planck import planck_band
    from sbdart_tpu_torch.ops.graph import CapturedCall

    lo, hi, temper, _ = _c5_chunk(cuda_device, ncol=64)

    def fn(lo, hi, t):
        return planck_band(lo[..., None], hi[..., None], t, torch.float32)

    call = CapturedCall(fn, capture=True)
    inputs = dict(lo=lo.contiguous(), hi=hi.contiguous(),
                  t=temper.contiguous())
    want = fn(**inputs)
    call(inputs)
    before = launches(planck_band)
    got = call(inputs)
    torch.cuda.synchronize()
    assert call.graph is not None and launches(planck_band) == before + 1
    _same_bits(got, want)
    lo2, hi2, t2, _ = _c5_chunk(cuda_device, ncol=64, seed=5)
    fresh = dict(lo=lo2.contiguous(), hi=hi2.contiguous(),
                 t=t2.contiguous())
    got = call(fresh)
    torch.cuda.synchronize()
    _same_bits(got, fn(**fresh))


@pytest.mark.cuda
@pytest.mark.parametrize("name, per_solve", [("nstr4-thermal-33L", 3),
                                             ("nstr4-flux-33L", 0)])
def test_flux_solve_launches(cuda_device, name, per_solve):
    """Three launches a thermal flux solve, eager or captured (a replay
    adds its capture's count), none on a solar-only one; the plain route
    (eig_method "plain") none."""
    import chip_smoke
    from sbdart_tpu_torch.kernels.planck import planck_band
    from sbdart_tpu_torch.solver.disort import solve_rte

    _, _, args, kw = chip_smoke.solve_cell(name, cuda_device, small=True)
    before = launches(planck_band)
    solve_rte(*args, **kw)
    assert launches(planck_band) == before + per_solve
    before = launches(planck_band)
    solve_rte(*args, **dict(kw, eig_method="plain"))
    assert launches(planck_band) == before
    call, inputs = chip_smoke.captured_solve(args, kw)
    before = launches(planck_band)
    for _ in range(3):          # warm-up; capture and replay; replay
        call(inputs)
    torch.cuda.synchronize()
    assert call.graph is not None
    assert launches(planck_band) == before + 3 * per_solve
