"""The thermal particular-solution kernel (csrc/thermal_particular.cu)
against its plain torch version
(kernels/thermal.py:thermal_particular_scan_plain) on a card, to the bit.

Marked `cuda`; skips where torch sees no CUDA device.  On a card (where
there is no JAX, so the repo conftest is left out):

    python -m pytest tests/test_torch_thermal_cuda.py -m cuda --noconftest -o addopts=''

The kernel rounds as ATen's CUDA kernels round the plain version, so the
two are held to equal bit patterns, NaN positions included, at:

  * config 5's band-chunk shape, 1024 columns x 32 bands x 3 k-terms x
    32 layers (N = 2), from delta-M-scaled optics and P1's level field;
  * N = 4, 6 and 8 on small batches; 130 columns (a ragged edge);
  * stride-0 expanded and non-contiguous inputs;
  * layers under the float32 slope floor;
  * unphysical moments that force a pivot swap in both solves, with
    NaN and zero lanes.

The wrapper refuses float64 CUDA tensors and shapes it does not take,
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


def _check(args, tab):
    from sbdart_tpu_torch.kernels.thermal import (
        thermal_particular_scan,
        thermal_particular_scan_plain,
    )

    before = launches(thermal_particular_scan)
    got = thermal_particular_scan(*args, tab)
    want = thermal_particular_scan_plain(*args, tab)
    torch.cuda.synchronize()
    assert launches(thermal_particular_scan) == before + 1
    assert got[3] is got[2]
    for g, w in zip(got, want):
        _same_bits(g, w)
    return got


def _operands(device, **kw):
    import chip_smoke

    return chip_smoke.thermal_operands(device, **kw)


@pytest.mark.cuda
def test_c5_band_chunk(cuda_device):
    args, tab = _operands(cuda_device)
    got = _check(args, tab)
    assert got[0].shape == (32, 2, 1024 * 32 * 3)
    assert got[0].is_contiguous() and torch.isfinite(got[0]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("nstr", [8, 12, 16])
def test_higher_orders(cuda_device, nstr):
    args, tab = _operands(cuda_device, ncol=16, nband=4, nstr=nstr)
    got = _check(args, tab)
    assert got[0].shape == (32, nstr // 2, 16 * 4 * 3)


@pytest.mark.cuda
def test_ragged_columns(cuda_device):
    args, tab = _operands(cuda_device, ncol=130, nband=3, seed=1)
    _check(args, tab)


@pytest.mark.cuda
def test_stride0_and_non_contiguous_inputs(cuda_device):
    (ssalb, dtau, gl, b_level), tab = _operands(cuda_device, ncol=6,
                                                nband=5, seed=2)
    # one column's optics expanded over 7 columns, as solve_rte broadcasts
    wide = [x[:1].expand((7,) + x.shape[1:]) for x in (ssalb, dtau, gl,
                                                        b_level)]
    assert all(x.stride(0) == 0 for x in wide)
    _check(wide, tab)
    # transposed batch dims, a step slice, an offset moment view
    ssalb_t = ssalb.transpose(0, 1).contiguous().transpose(0, 1)
    dtau_s = torch.cat([dtau, dtau], dim=-1)[..., ::2]
    gl_big = torch.zeros(gl.shape[:-1] + (9,), device=cuda_device)
    gl_big[..., 2:6] = gl
    gl_o = gl_big[..., 2:6]
    b_t = b_level.permute(2, 0, 1, 3).contiguous().permute(1, 2, 0, 3)
    views = (ssalb_t, dtau_s, gl_o, b_t)
    assert not any(v.is_contiguous() for v in views)
    _check(views, tab)
    # a batch shared by broadcasting: b_level one per band
    _check((ssalb, dtau, gl, b_level[:1, :, :1]), tab)


@pytest.mark.cuda
def test_layers_under_the_slope_floor(cuda_device):
    from sbdart_tpu_torch.constants import slope_tau_floor

    args, tab = _operands(cuda_device, ncol=64, nband=4, floor_share=0.3,
                          seed=3)
    floor = slope_tau_floor(torch.float32)
    assert (args[1] < floor).float().mean() > 0.2
    dtau = args[1].clone()
    dtau[0, 0, 0, :4] = torch.tensor([0.0, -0.0, floor, 1e-30])
    _check((args[0], dtau, *args[2:]), tab)


@pytest.mark.cuda
@pytest.mark.parametrize("nstr", [4, 8])
def test_pivot_swaps_in_both_solves(cuda_device, nstr):
    """Moments U(-3, 3) make |alpha -+ beta|'s first column largest off
    the diagonal in some lanes of each system; NaN, zero and infinite
    inputs in a few lanes."""
    from sbdart_tpu_torch.kernels.thermal import mode0_matrices

    args, tab = _operands(cuda_device, ncol=256, nband=4, nstr=nstr,
                          moments=(-3.0, 3.0), seed=4)
    ssalb, dtau, gl, b_level = (x.clone() for x in args)
    gl[..., 0] = 1.0
    ssalb[0, 0, 0, 0] = float("nan")
    dtau[0, 0, 0, 1] = float("nan")
    gl[0, 0, 0, 2, 1] = float("nan")
    b_level[0, 0, 1, 3] = float("nan")
    ssalb[0, 0, 2, :] = 0.0
    gl[0, 1, 0, 5, 1:] = 0.0
    b_level[0, 1, 1, 7] = float("inf")
    mu = torch.tensor(tab.mu, device=cuda_device, dtype=torch.float32)
    w = torch.tensor(tab.w, device=cuda_device, dtype=torch.float32)
    cpp, cpm = mode0_matrices(ssalb, gl, tab)
    eye = torch.eye(nstr // 2, device=cuda_device)
    for c in (cpp + cpm, cpp - cpm):
        a = (1.0 / mu)[:, None] * (eye - c * w)
        swaps = a[..., 1:, 0].abs().amax(-1) > a[..., 0, 0].abs()
        assert int(swaps.sum()) > 10
    got = _check((ssalb, dtau, gl, b_level), tab)
    assert bool(torch.isnan(got[0]).any())


@pytest.mark.cuda
def test_refusals(cuda_device):
    from sbdart_tpu_torch.kernels.thermal import thermal_particular_scan
    from sbdart_tpu_torch.solver.eig import angular_tables

    args, tab = _operands(cuda_device, ncol=4, nband=2)
    before = launches(thermal_particular_scan)
    with pytest.raises(TypeError, match="float32-only"):
        thermal_particular_scan(*(x.double() for x in args), tab)
    ssalb, dtau, gl, b_level = args
    with pytest.raises(ValueError, match="b_level"):
        thermal_particular_scan(ssalb, dtau, gl, b_level[..., 1:], tab)
    with pytest.raises(ValueError, match="nstr"):
        thermal_particular_scan(ssalb, dtau, gl[..., :3], b_level, tab)
    with pytest.raises(ValueError, match="tables"):
        thermal_particular_scan(ssalb, dtau, gl, b_level,
                                angular_tables(8, 1))
    with pytest.raises(ValueError, match="ssalb"):
        thermal_particular_scan(ssalb[..., 1:], dtau, gl, b_level, tab)
    assert launches(thermal_particular_scan) == before


@pytest.mark.cuda
def test_replay_equals_eager(cuda_device):
    from sbdart_tpu_torch.kernels.thermal import thermal_particular_scan
    from sbdart_tpu_torch.ops.graph import CapturedCall

    args, tab = _operands(cuda_device, ncol=64, nband=4)

    def fn(ssalb, dtau, gl, b_level):
        return thermal_particular_scan(ssalb, dtau, gl, b_level, tab)[:3]

    call = CapturedCall(fn, capture=True)
    inputs = dict(zip(("ssalb", "dtau", "gl", "b_level"), args))
    want = fn(**inputs)
    call(inputs)
    before = launches(thermal_particular_scan)
    got = call(inputs)
    torch.cuda.synchronize()
    assert call.graph is not None
    assert launches(thermal_particular_scan) == before + 1
    for g, w in zip(got, want):
        _same_bits(g, w)
    fresh_args, _ = _operands(cuda_device, ncol=64, nband=4, seed=5)
    fresh = dict(zip(("ssalb", "dtau", "gl", "b_level"), fresh_args))
    got = call(fresh)
    torch.cuda.synchronize()
    for g, w in zip(got, fn(**fresh)):
        _same_bits(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("name, per_solve", [("nstr4-thermal-33L", 1),
                                             ("nstr4-flux-33L", 0)])
def test_flux_solve_launches(cuda_device, name, per_solve):
    """One launch a thermal flux solve, eager or captured (a replay adds
    its capture's count), none on a solar-only one; the plain route
    (eig_method "plain") none."""
    import chip_smoke
    from sbdart_tpu_torch.kernels.thermal import thermal_particular_scan
    from sbdart_tpu_torch.solver.disort import solve_rte

    _, _, args, kw = chip_smoke.solve_cell(name, cuda_device, small=True)
    before = launches(thermal_particular_scan)
    solve_rte(*args, **kw)
    assert launches(thermal_particular_scan) == before + per_solve
    before = launches(thermal_particular_scan)
    solve_rte(*args, **dict(kw, eig_method="plain"))
    assert launches(thermal_particular_scan) == before
    call, inputs = chip_smoke.captured_solve(args, kw)
    before = launches(thermal_particular_scan)
    for _ in range(3):          # warm-up; capture and replay; replay
        call(inputs)
    torch.cuda.synchronize()
    assert call.graph is not None
    assert launches(thermal_particular_scan) == before + 3 * per_solve
