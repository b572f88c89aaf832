"""The nstr=4 thermal front end's delta-M and beam-attenuation kernel
(csrc/deltam_attenuation.cu) against its plain torch version
(kernels/deltam_attenuation.py:deltam_attenuation_plain) on a card, to
the bit.

Marked `cuda`; skips where torch sees no CUDA device.  On a card (where
there is no JAX, so the repo conftest is left out):

    python -m pytest tests/test_torch_deltam_attenuation_cuda.py -m cuda --noconftest -o addopts=''

The kernel rounds as ATen's CUDA kernels round the plain version, whose
scans are explicit loops of adds, so the two are held to equal bit
patterns, NaN positions included, at:

  * config 5's band-chunk shapes, 1024 columns x 32 bands (one card) and
    x 36 (the grid) x 3 k-terms x 32 layers, on beam_rows' mu0 and
    has_beam with a fifth of the bands without a beam;
  * 130 columns (a ragged edge), with NaN lanes and a grazing beam;
  * delta-M off, and moments fewer than nstr;
  * stride-0 expanded and non-contiguous inputs.

The wrapper refuses non-float32 CUDA tensors and shapes it does not take,
launches once a call, and once a band-chunk flux solve with Planck
(eager or captured), none on a solar-only one or the plain route.
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


def _check(args, deltam=True):
    from sbdart_tpu_torch.kernels.deltam_attenuation import (
        deltam_attenuation,
        deltam_attenuation_plain,
    )

    before = launches(deltam_attenuation)
    got = deltam_attenuation(*args, deltam)
    want = deltam_attenuation_plain(*args, deltam)
    torch.cuda.synchronize()
    assert launches(deltam_attenuation) == before + 1
    for g, w in zip(got, want):
        assert g.is_contiguous()
        _same_bits(g, w)
    return got


def _operands(device, **kw):
    import chip_smoke

    return chip_smoke.deltam_operands(device, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("nband", [32, 36])
def test_c5_band_chunks(cuda_device, nband):
    args = _operands(cuda_device, nband=nband)
    assert (~args[4]).any() and args[4].any()
    got = _check(args)
    nb = 1024 * nband * 3
    assert got[2].shape == (32, 4, nb) and got[3].shape == (33, nb)
    assert all(bool(torch.isfinite(g).all()) for g in got)


@pytest.mark.cuda
@pytest.mark.parametrize("deltam", [True, False])
def test_ragged_columns_with_nan_lanes(cuda_device, deltam):
    dtau, ssalb, pmom, mu0, has_beam = (
        x.clone() for x in _operands(cuda_device, ncol=130, nband=3,
                                     seed=1))
    dtau[3, 1, 2, 7] = float("nan")
    ssalb[100, 0, 0, 0] = float("nan")
    pmom[129, 2, 1, 4, 4] = float("nan")
    pmom[128, 2, 1, 5, 4] = 1.5          # f clamped below 1
    mu0[7, 0, 0] = 0.0                   # a grazing beam: -0 / 0
    has_beam[7, 0, 0] = True
    got = _check((dtau, ssalb, pmom, mu0, has_beam), deltam)
    assert bool(torch.isnan(got[4]).any())


@pytest.mark.cuda
@pytest.mark.parametrize("nmom", [1, 3, 4, 9])
def test_fewer_and_more_moments(cuda_device, nmom):
    dtau, ssalb, pmom, mu0, has_beam = _operands(cuda_device, ncol=70,
                                                 nband=2, seed=2)
    g = pmom[..., 1:2]
    more = g ** torch.arange(nmom, device=cuda_device)
    _check((dtau, ssalb, more, mu0, has_beam))


@pytest.mark.cuda
def test_stride0_and_non_contiguous_inputs(cuda_device):
    dtau, ssalb, pmom, mu0, has_beam = _operands(cuda_device, ncol=6,
                                                 nband=5, seed=3)
    # one column's optics expanded over 7 columns, moments shared by the
    # k-terms, as solve_rte broadcasts them
    wide = (dtau[:1].expand(7, 5, 3, 32), ssalb[:1].expand(7, 5, 3, 32),
            pmom[:1, :, :1].expand(7, 5, 3, 32, 5), mu0[:1].expand(7, 5, 3),
            has_beam[:1].expand(7, 5, 3))
    assert all(x.stride(0) == 0 for x in wide)
    _check(wide)
    # transposed batch dims, a step slice, an offset moment view
    dtau_t = dtau.transpose(0, 1).contiguous().transpose(0, 1)
    ssalb_s = torch.cat([ssalb, ssalb], dim=-1)[..., ::2]
    pm_big = torch.zeros(pmom.shape[:-1] + (9,), device=cuda_device)
    pm_big[..., 2:7] = pmom
    pm_o = pm_big[..., 2:7]
    mu0_t = mu0.permute(2, 0, 1).contiguous().permute(1, 2, 0)
    views = (dtau_t, ssalb_s, pm_o, mu0_t, has_beam)
    assert not any(v.is_contiguous() for v in views[:4])
    _check(views)


@pytest.mark.cuda
def test_refusals(cuda_device):
    from sbdart_tpu_torch.kernels.deltam_attenuation import (
        deltam_attenuation,
    )

    dtau, ssalb, pmom, mu0, has_beam = _operands(cuda_device, ncol=4,
                                                 nband=2)
    before = launches(deltam_attenuation)
    with pytest.raises(TypeError, match="float32-only"):
        deltam_attenuation(dtau.double(), ssalb.double(), pmom.double(),
                           mu0.double(), has_beam)
    with pytest.raises(ValueError, match="has_beam"):
        deltam_attenuation(dtau, ssalb, pmom, mu0, has_beam.float())
    with pytest.raises(ValueError, match="layers"):
        deltam_attenuation(dtau, ssalb[..., 1:], pmom, mu0, has_beam)
    with pytest.raises(ValueError, match="layers"):
        deltam_attenuation(dtau, ssalb, pmom[..., 1:, :], mu0, has_beam)
    with pytest.raises(ValueError, match="CUDA device"):
        deltam_attenuation(dtau, ssalb.cpu(), pmom, mu0, has_beam)
    assert launches(deltam_attenuation) == before


@pytest.mark.cuda
def test_replay_equals_eager(cuda_device):
    from sbdart_tpu_torch.kernels.deltam_attenuation import (
        deltam_attenuation,
    )
    from sbdart_tpu_torch.ops.graph import CapturedCall

    names = ("dtau", "ssalb", "pmom", "mu0", "has_beam")
    call = CapturedCall(deltam_attenuation, capture=True)
    inputs = dict(zip(names, _operands(cuda_device, ncol=64, nband=4)))
    want = deltam_attenuation(**inputs)
    call(inputs)
    before = launches(deltam_attenuation)
    got = call(inputs)
    torch.cuda.synchronize()
    assert call.graph is not None
    assert launches(deltam_attenuation) == before + 1
    for g, w in zip(got, want):
        _same_bits(g, w)
    fresh = dict(zip(names, _operands(cuda_device, ncol=64, nband=4,
                                      seed=5)))
    got = call(fresh)
    torch.cuda.synchronize()
    for g, w in zip(got, deltam_attenuation(**fresh)):
        _same_bits(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("name, per_solve", [("nstr4-thermal-33L", 1),
                                             ("nstr4-flux-33L", 0)])
def test_flux_solve_launches(cuda_device, name, per_solve):
    """One launch a thermal flux solve, eager or captured (a replay adds
    its capture's count), none on a solar-only one; the plain route
    (eig_method "plain") none."""
    import chip_smoke
    from sbdart_tpu_torch.kernels.deltam_attenuation import (
        deltam_attenuation,
    )
    from sbdart_tpu_torch.solver.disort import solve_rte

    _, _, args, kw = chip_smoke.solve_cell(name, cuda_device, small=True)
    before = launches(deltam_attenuation)
    solve_rte(*args, **kw)
    assert launches(deltam_attenuation) == before + per_solve
    before = launches(deltam_attenuation)
    solve_rte(*args, **dict(kw, eig_method="plain"))
    assert launches(deltam_attenuation) == before
    call, inputs = chip_smoke.captured_solve(args, kw)
    before = launches(deltam_attenuation)
    for _ in range(3):          # warm-up; capture and replay; replay
        call(inputs)
    torch.cuda.synchronize()
    assert call.graph is not None
    assert launches(deltam_attenuation) == before + 3 * per_solve
