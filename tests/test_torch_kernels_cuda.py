"""The port's CUDA kernels against their plain torch versions, on a card.

Marked `cuda`; skips where torch sees no CUDA device.  On a card (where
there is no JAX, so the repo conftest is left out):

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -o addopts=''

Bar: the reference's compiled-kernel bar, rtol 1e-4 / atol 1e-5
(tests/test_pallas_kernels.py:142), at the main path's shapes (B1/B2/B3:
33 layers x 49152 columns; B4/B5: 33 layers x 6144 columns at N = 4, 6
and 8; B6: 65 layers x 6144 columns at N = 4, 6 and 8; B5/B6 at N = 2:
65 layers x 49152 columns; B7 on the radiance path's operands at nstr 16
(65 layers x 256 columns), 12, 8 and 4; B8 at 4 modes x 33 layers x 4096
columns; B4 on the flat radiance lane axis) and an unaligned 130.  The
kernels are built with --fmad=false and follow their plain versions'
operation order, so they agree to the last bit on the H100: B4, B9, B10
and the group kernels are held to equality here, NaN positions included
(a NaN injected in one column); so is B7 on the radiance path's own
strided views at N = 2, 4, 6 and 8, U = 1 and 20 and 130 lanes, with
resonance lanes, a NaN lane and lanes that take its exact division.
"""

import numpy as np
import pytest
import torch

from launch_counts import launches


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on a card")
    return torch.device("cuda", 0)


def _problem(ncol, device):
    import chip_smoke

    prob = chip_smoke.flux_problem(ncol, 1, 33, device)
    return chip_smoke.kernel_operands(prob)


def _general(ncol, nstr, device, nlyr=33):
    import chip_smoke

    prob = chip_smoke.flux_problem(ncol, 1, nlyr, device, nmom=nstr + 1,
                                   planck=nstr == 4)
    return chip_smoke.general_kernel_operands(prob, nstr)


def _assert_close(got, want, name):
    assert got.shape == want.shape, name
    assert torch.isfinite(got).all(), name
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5, msg=name)


NAMES = ("kk", "gp", "gm", "zp", "zm")


@pytest.mark.cuda
@pytest.mark.parametrize("ncol", [49152, 130])
def test_eig_n2_kernel_matches_plain(cuda_device, ncol):
    from sbdart_tpu_torch.kernels.eig_n2 import (
        eig_beam_deltam_scatter_n2, eig_beam_deltam_scatter_n2_plain)

    ops, use_dm, tab, _ = _problem(ncol, cuda_device)
    before = launches(eig_beam_deltam_scatter_n2)
    got = eig_beam_deltam_scatter_n2(*ops, tab, use_deltam=use_dm)
    torch.cuda.synchronize()
    assert launches(eig_beam_deltam_scatter_n2) == before + 1
    want = eig_beam_deltam_scatter_n2_plain(*ops, tab, use_deltam=use_dm)
    for name, g, w in zip(NAMES + ("dts", "ee"), got, want):
        _assert_close(g, w, name)


@pytest.mark.cuda
@pytest.mark.parametrize("ncol", [49152, 49156, 130])
def test_blocktri_n2_kernel_matches_plain(cuda_device, ncol):
    """B2 at 33 layers, equal to its plain version element for element,
    with a NaN in one column's right-hand side: whole blocks, a last block
    of 4 columns (16-byte copies with the tail guards), and 4-byte copies
    (130 columns)."""
    from sbdart_tpu_torch.kernels.blocktri_n2 import (
        block_thomas_rt_n2, block_thomas_rt_n2_plain)

    _, _, _, ops = _problem(ncol, cuda_device)
    ops = tuple(ops[:4]) + (_nan_column(ops[4], ncol // 2),)
    before = launches(block_thomas_rt_n2)
    got = block_thomas_rt_n2(*ops)
    torch.cuda.synchronize()
    assert launches(block_thomas_rt_n2) == before + 1
    _assert_equal(got, block_thomas_rt_n2_plain(*ops), "xs")
    assert bool(torch.isnan(got).any())


@pytest.mark.cuda
@pytest.mark.parametrize("ncol", [49152, 130])
def test_eig_n2_scatter_kernel_matches_plain(cuda_device, ncol):
    from sbdart_tpu_torch.kernels.eig_n2_scatter import (
        eig_beam_scatter_n2, eig_beam_scatter_n2_plain)

    ops, _ = _general(ncol, 4, cuda_device)
    before = launches(eig_beam_scatter_n2)
    got = eig_beam_scatter_n2(*ops)
    torch.cuda.synchronize()
    assert launches(eig_beam_scatter_n2) == before + 1
    for name, g, w in zip(NAMES, got, eig_beam_scatter_n2_plain(*ops)):
        _assert_close(g, w, name)


def _nan_column(t, col, layer=1):
    """A copy of a column-minor operand [L, ..., B] with NaN in one
    element of column `col` (layer `layer`, or the last)."""
    t = t.clone()
    idx = (min(layer, t.shape[0] - 1),) + (0,) * (t.dim() - 2) + (col,)
    t[idx] = float("nan")
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("nstr", [8, 12, 16])
@pytest.mark.parametrize("ncol", [6144, 130])
def test_eig_beam_kernel_matches_plain(cuda_device, nstr, ncol):
    """B4 (the group kernel) at N = 4, 6, 8 on the flux path's layered
    operands (33 layers), equal to its plain version with a NaN in one
    column's C^pp."""
    from sbdart_tpu_torch.kernels.eig_beam import (
        eig_beam_chain, eig_beam_chain_plain)

    ops, _ = _general(ncol, nstr, cuda_device)
    ops = (_nan_column(ops[0], ncol // 2),) + tuple(ops[1:])
    before = launches(eig_beam_chain)
    got = eig_beam_chain(*ops)
    torch.cuda.synchronize()
    assert launches(eig_beam_chain) == before + 1
    want = eig_beam_chain_plain(*ops)
    for name, g, w in zip(NAMES, got, want):
        _assert_equal(g, w, name)
    assert bool(torch.isnan(got[0]).any())


@pytest.mark.cuda
@pytest.mark.parametrize("nstr", [8, 12, 16])
@pytest.mark.parametrize("ncol", [6144, 130])
def test_blocktri_rt_kernel_matches_plain(cuda_device, nstr, ncol):
    from sbdart_tpu_torch.kernels.blocktri_rt import (
        block_thomas_rt, block_thomas_rt_plain)

    _, ops = _general(ncol, nstr, cuda_device)
    before = _rt_launches()
    got = block_thomas_rt(*ops)
    torch.cuda.synchronize()
    assert _rt_launches() == before + 1
    _assert_close(got, block_thomas_rt_plain(*ops), "xs")


def _rt_launches():
    """Launches of B5's two kernels (the design by N of
    blocktri_rt.RT_ONE_THREAD_N)."""
    from sbdart_tpu_torch.kernels.blocktri_rt import (
        block_thomas_rt, block_thomas_rt_group)

    return launches(block_thomas_rt) + launches(block_thomas_rt_group)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8, 9])
@pytest.mark.parametrize("ncol", [6144, 130])
def test_blocktri_rt_routes_each_n(cuda_device, n, ncol):
    """B5 through block_thomas_rt's route at N = 1 to 9 (33 layers), equal
    to its plain version with the NaN column; the launch counters show
    the body RT_ONE_THREAD_N names ran."""
    from sbdart_tpu_torch.kernels.blocktri_rt import (
        RT_ONE_THREAD_N, block_thomas_rt, block_thomas_rt_group,
        block_thomas_rt_plain)

    ops = _bvp_operands(n, 33, ncol, cuda_device)
    before = (launches(block_thomas_rt), launches(block_thomas_rt_group))
    got = block_thomas_rt(*ops)
    torch.cuda.synchronize()
    one = n in RT_ONE_THREAD_N
    assert (launches(block_thomas_rt), launches(block_thomas_rt_group)) == (
        before[0] + one, before[1] + (not one))
    _assert_equal(got, block_thomas_rt_plain(*ops), "xs")
    assert bool(torch.isnan(got).any())


@pytest.mark.cuda
@pytest.mark.parametrize("nstr", [8, 12, 16])
@pytest.mark.parametrize("ncol", [6144, 6148, 130])
def test_blocktri_rt_streamed_kernels_match_plain(cuda_device, nstr, ncol):
    """B6: the forward kernel against its plain version, the backward
    kernel against its plain version on the plain forward's history, each
    through its route, equal element for element with a NaN in one
    column's right-hand side; 6148 columns end the backward kernel's last
    block at 4 columns (16-byte copies with the tail guards)."""
    from sbdart_tpu_torch.kernels.blocktri_rt_streamed import (
        block_thomas_rt_bwd, block_thomas_rt_bwd_plain, block_thomas_rt_fwd,
        block_thomas_rt_fwd_plain)

    _, ops = _general(ncol, nstr, cuda_device, nlyr=65)
    ops = tuple(ops[:4]) + (_nan_column(ops[4], ncol // 2),)
    before = (_fwd_launches(), _bwd_launches())
    cs, ys = block_thomas_rt_fwd(*ops)
    cs_p, ys_p = block_thomas_rt_fwd_plain(*ops)
    xs = block_thomas_rt_bwd(*ops[:3], cs_p, ys_p)
    torch.cuda.synchronize()
    assert (_fwd_launches(), _bwd_launches()) == (before[0] + 1,
                                                  before[1] + 1)
    _assert_equal(cs, cs_p, "cs")
    _assert_equal(ys, ys_p, "ys")
    _assert_equal(xs, block_thomas_rt_bwd_plain(*ops[:3], cs_p, ys_p), "xs")
    assert bool(torch.isnan(xs).any())


def _fwd_launches():
    """Launches of B6 forward's two kernels (the design by N of
    blocktri_rt_streamed.FWD_ONE_THREAD_N)."""
    from sbdart_tpu_torch.kernels.blocktri_rt_streamed import (
        block_thomas_rt_fwd, block_thomas_rt_fwd_group)

    return launches(block_thomas_rt_fwd) + launches(block_thomas_rt_fwd_group)


def _bwd_launches():
    """Launches of B6 backward's kernel (the lane group kernel at every N:
    blocktri_rt_streamed.BWD_ONE_THREAD_N is empty)."""
    from sbdart_tpu_torch.kernels.blocktri_rt_streamed import (
        block_thomas_rt_bwd_group)

    return launches(block_thomas_rt_bwd_group)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 16])
@pytest.mark.parametrize("ncol", [6144, 130])
def test_blocktri_rt_bwd_routes_each_n(cuda_device, n, ncol):
    """B6 backward through block_thomas_rt_bwd's route at N = 1 to 10 and
    16 (33 layers, on the plain forward's history of the NaN column's
    operands), equal to its plain version; the launch counter shows the
    lane group kernel ran at each N outside BWD_ONE_THREAD_N (every N:
    no one-thread backward kernel is built)."""
    from sbdart_tpu_torch.kernels.blocktri_rt_streamed import (
        BWD_ONE_THREAD_N, block_thomas_rt_bwd, block_thomas_rt_bwd_group,
        block_thomas_rt_bwd_plain, block_thomas_rt_fwd_plain, bwd_entry)

    ops = _bvp_operands(n, 33, ncol, cuda_device)
    hist = block_thomas_rt_fwd_plain(*ops)
    before = launches(block_thomas_rt_bwd_group)
    got = block_thomas_rt_bwd(*ops[:3], *hist)
    torch.cuda.synchronize()
    assert n not in BWD_ONE_THREAD_N
    assert bwd_entry(n) == "sbdart_blocktri_rt_bwd_group"
    assert launches(block_thomas_rt_bwd_group) == before + 1
    _assert_equal(got, block_thomas_rt_bwd_plain(*ops[:3], *hist), "xs")
    assert bool(torch.isnan(got).any())


@pytest.mark.cuda
@pytest.mark.parametrize("n,ncol", [(17, 2112), (64, 264), (64, 12), (80, 3),
                                    (100, 3), (119, 3)])
def test_blocktri_rt_bwd_past_n16_matches_plain(cuda_device, n, ncol):
    """B6 backward's run-time-N instance on an H100's 132 SMs where its
    ring holds 2 slots of 16 columns (N = 17 x 2112 columns), 1 slot of 2
    columns (N = 64 x 264), 3 slots of one column (N = 64 x 12, G10's
    deck), 2 slots of one column (N = 80) and 1 (N = 100, and 119, the
    last N whose slot fits the card's shared memory), on 3 layers of
    random history with a NaN in one column, equal to its plain version;
    N = 120 is refused, naming the limit."""
    from sbdart_tpu_torch.kernels.blocktri_rt_streamed import (
        block_thomas_rt_bwd_group, block_thomas_rt_bwd_plain)

    gp, gm, ee, _, _ = _bvp_operands(n, 3, ncol, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    cs = 0.1 * torch.randn((3, 2 * n, n, ncol), generator=gen,
                           device=cuda_device)
    ys = torch.randn((3, 2 * n, ncol), generator=gen, device=cuda_device)
    ys[1, 0, 1] = float("nan")
    got = block_thomas_rt_bwd_group(gp, gm, ee, cs, ys)
    torch.cuda.synchronize()
    _assert_equal(got, block_thomas_rt_bwd_plain(gp, gm, ee, cs, ys), "xs")
    assert bool(torch.isnan(got).any())
    if n == 119:
        ops = _bvp_operands(120, 2, 1, cuda_device)
        hist = (torch.zeros((2, 240, 120, 1), device=cuda_device),
                torch.zeros((2, 240, 1), device=cuda_device))
        with pytest.raises(ValueError, match="shared memory.*N up to 119"):
            block_thomas_rt_bwd_group(*ops[:3], *hist)


def _radiance(nstr, nlyr, nbc, device):
    import chip_smoke

    return chip_smoke.radiance_kernel_operands(
        *chip_smoke.radiance_problem(nbc, nlyr, device, nstr=nstr))


@pytest.mark.cuda
@pytest.mark.parametrize("ncol", [49152, 130])
def test_bvp_kernels_at_n2_match_plain(cuda_device, ncol):
    """B5 and B6 at N = 2 (nstr=4 from 52 layers on), 65 layers."""
    import chip_smoke
    from sbdart_tpu_torch.kernels.blocktri_rt import (
        block_thomas_rt, block_thomas_rt_plain)
    from sbdart_tpu_torch.kernels.blocktri_rt_streamed import (
        block_thomas_rt_bwd, block_thomas_rt_bwd_plain, block_thomas_rt_fwd,
        block_thomas_rt_fwd_plain)

    prob = chip_smoke.flux_problem(ncol, 1, 65, cuda_device)
    *_, ops = chip_smoke.kernel_operands(prob)
    before = (_rt_launches(), _bwd_launches())
    got = block_thomas_rt(*ops)
    cs, ys = block_thomas_rt_fwd(*ops)
    cs_p, ys_p = block_thomas_rt_fwd_plain(*ops)
    xs = block_thomas_rt_bwd(*ops[:3], cs_p, ys_p)
    torch.cuda.synchronize()
    assert (_rt_launches(), _bwd_launches()) == (before[0] + 1,
                                                 before[1] + 1)
    _assert_close(got, block_thomas_rt_plain(*ops), "xs (B5)")
    _assert_close(cs, cs_p, "cs")
    _assert_close(ys, ys_p, "ys")
    _assert_close(xs, block_thomas_rt_bwd_plain(*ops[:3], cs_p, ys_p), "xs")


def _radsrc_views(nstr, nlyr, nbc, device, umu=None):
    """B7's operands as the radiance path hands them (gp, gm, kk, zp, zm
    views of the eigen output), at the user cosines `umu` (chip_smoke's
    five by default, or the name of one of its sets)."""
    import chip_smoke

    umu = getattr(chip_smoke, umu) if isinstance(umu, str) else umu
    return chip_smoke.radsrc_operands(device, nstr, nlyr, nbc,
                                      umu or chip_smoke.UMU_VIEW)


@pytest.mark.cuda
@pytest.mark.parametrize("nstr,nlyr,nbc,umu", [
    (16, 65, 256, None), (16, 65, 2, None), (12, 33, 64, None),
    (8, 33, 64, None), (4, 33, 130, None), (16, 33, 64, (0.7,)),
    (16, 33, 64, "UMU_20")])
def test_radsrc_kernel_matches_plain(cuda_device, nstr, nlyr, nbc, umu):
    """B7 on the path's own strided views, bit for bit: N = 8, 6, 4, 2,
    130 lanes (65 x 2), U = 1 and 20."""
    from sbdart_tpu_torch.kernels.radsrc import (
        rad_source_lane, rad_source_lane_plain)

    src, umu = _radsrc_views(nstr, nlyr, nbc, cuda_device, umu)
    assert not src[5].is_contiguous() and src[5].stride(-1) == 1
    before = launches(rad_source_lane)
    got = rad_source_lane(*src, umu)
    torch.cuda.synchronize()
    assert launches(rad_source_lane) == before + 1
    _assert_equal(got, rad_source_lane_plain(*src, umu), "j")


@pytest.mark.cuda
@pytest.mark.parametrize("nstr,nlyr,nbc", [(4, 33, 64), (16, 65, 256),
                                           (16, 65, 2)])
def test_radsrc_kernel_equals_plain_on_resonance_and_nan(cuda_device, nstr,
                                                         nlyr, nbc):
    """B7 with one lane of mode 1 put on the 'away' resonance at each user
    cosine, kk = (1 +- 1e-6) / |u| (tests/test_torch_radsrc.py), a NaN in
    another lane's G+, and two lanes whose path integrals leave the
    kernel's branch-free division (dtau = 0: a zero numerator; dtau = 200:
    both exponentials underflow), written through the path's views: bit
    for bit, NaN positions included."""
    from sbdart_tpu_torch.kernels.radsrc import (
        rad_source_lane, rad_source_lane_plain)

    src, umu = _radsrc_views(nstr, nlyr, nbc, cuda_device)
    kk, gp, dtau = src[7], src[5], src[12]
    for u_i, u in enumerate(umu):
        kk[1, 0, u_i] = (1.0 + (1e-6 if u_i % 2 else -1e-6)) / abs(u)
    gp[1, 0, 1, len(umu) + 1] = float("nan")
    dtau[..., len(umu) + 2] = 0.0
    dtau[..., len(umu) + 3] = 200.0
    got = rad_source_lane(*src, umu)
    want = rad_source_lane_plain(*src, umu)
    torch.cuda.synchronize()
    assert bool(torch.isnan(want).any())
    _assert_equal(got, want, "j")


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [None, 130])
def test_eig_n2_planar_kernel_matches_plain(cuda_device, lanes):
    """B8 on the nstr=4 radiance path's flat lane axis (4 x 33 x 4096)
    and on its first 130 lanes."""
    from sbdart_tpu_torch.kernels.eig_n2 import (
        eig_beam_chain_n2, eig_beam_chain_n2_plain)

    (cppl, cpml, r1, r2, mu0, tab), _ = _radiance(4, 33, 4096, cuda_device)[
        "eig_beam_chain_lane"]
    ops = tuple(x[None, ..., :lanes].contiguous() for x in (cppl, cpml, r1,
                                                           r2))
    ops += (mu0[..., :lanes].contiguous(),)
    before = launches(eig_beam_chain_n2)
    got = eig_beam_chain_n2(*ops, tab)
    torch.cuda.synchronize()
    assert launches(eig_beam_chain_n2) == before + 1
    for name, g, w in zip(NAMES, got, eig_beam_chain_n2_plain(*ops, tab)):
        _assert_close(g, w, name)


@pytest.mark.cuda
@pytest.mark.parametrize("nstr", [8, 12, 16])
@pytest.mark.parametrize("lanes", [6144, 130])
def test_eig_beam_flat_entry_matches_plain(cuda_device, nstr, lanes):
    """B4 on the flat radiance lane axis (nstr modes x 33 layers x 64
    band-columns), its first 6144 and 130 lanes, equal to the plain
    version with a NaN in one lane's C^pp."""
    from sbdart_tpu_torch import kernels
    from sbdart_tpu_torch.kernels.eig_beam import (
        eig_beam_chain, eig_beam_chain_lane)

    (cppl, cpml, r1, r2, mu0, tab), _ = _radiance(nstr, 33, 64, cuda_device)[
        "eig_beam_chain_lane"]
    cppl, cpml, r1, r2 = (x[..., :lanes].contiguous()
                          for x in (cppl, cpml, r1, r2))
    mu0 = mu0[..., :lanes].contiguous()
    cppl = _nan_column(cppl[None], lanes // 2)[0]
    before = launches(eig_beam_chain)
    got = eig_beam_chain_lane(cppl, cpml, r1, r2, mu0, tab)
    torch.cuda.synchronize()
    assert launches(eig_beam_chain) == before + 1
    with kernels.plain():
        want = eig_beam_chain_lane(cppl, cpml, r1, r2, mu0, tab)
    for name, g, w in zip(NAMES, got, want):
        _assert_equal(g, w, name)


@pytest.mark.cuda
@pytest.mark.parametrize("nstr,brdf", [(4, False), (8, True), (12, True),
                                       (16, False)])
def test_radiance_solve_kernels_match_plain(cuda_device, nstr, brdf):
    """solve_rte(onlyfl=False) in float32 through the kernels against the
    plain path on the card, with the thermal source, 130 band-columns x 9
    layers: every field within chip_smoke's 5e-4 of its max."""
    import chip_smoke
    from sbdart_tpu_torch.kernels.radsrc import rad_source_lane
    from sbdart_tpu_torch.solver.disort import solve_rte

    args, kw = chip_smoke.radiance_problem(130, 9, cuda_device, nstr=nstr,
                                           planck=True, brdf=brdf)
    before = launches(rad_source_lane)
    got = solve_rte(*args, dtype=torch.float32, **kw)
    want = solve_rte(*args, dtype=torch.float32, eig_method="plain", **kw)
    assert launches(rad_source_lane) == before + 1
    for name in ("uu", "rfldir", "rfldn", "flup", "uavg", "dfdt"):
        g, w = getattr(got, name), getattr(want, name)
        assert torch.isfinite(g).all(), name
        err = float((g - w).abs().max() / w.abs().max().clamp_min(1e-9))
        assert err <= chip_smoke.E2E_BAR, (name, err)


@pytest.mark.cuda
def test_kernels_refuse_float64_on_card(cuda_device):
    from sbdart_tpu_torch.kernels.blocktri_n2 import block_thomas_rt_n2
    from sbdart_tpu_torch.kernels.blocktri_rt import block_thomas_rt
    from sbdart_tpu_torch.kernels.blocktri_rt_streamed import (
        block_thomas_rt_bwd, block_thomas_rt_fwd)
    from sbdart_tpu_torch.kernels.eig_beam import eig_beam_chain
    from sbdart_tpu_torch.kernels.eig_n2_scatter import eig_beam_scatter_n2

    _, _, _, ops = _problem(130, cuda_device)
    with pytest.raises(TypeError, match="float32"):
        block_thomas_rt_n2(*(x.double() for x in ops))
    front, bvp = _general(130, 4, cuda_device)
    with pytest.raises(TypeError, match="float32"):
        eig_beam_scatter_n2(*(x.double() for x in front[:4]), front[4])
    front, bvp = _general(130, 16, cuda_device)
    with pytest.raises(TypeError, match="float32"):
        eig_beam_chain(*(x.double() for x in front[:5]), *front[5:])
    with pytest.raises(TypeError, match="float32"):
        block_thomas_rt(*(x.double() for x in bvp))
    with pytest.raises(TypeError, match="float32"):
        block_thomas_rt_fwd(*(x.double() for x in bvp))
    hist = block_thomas_rt_fwd(*bvp)
    with pytest.raises(TypeError, match="float32"):
        block_thomas_rt_bwd(*(x.double() for x in bvp[:3] + hist))
    from sbdart_tpu_torch.kernels.eig_n2 import eig_beam_chain_n2
    from sbdart_tpu_torch.kernels.radsrc import rad_source_lane

    ops = _radiance(4, 5, 3, cuda_device)
    *src, umu = ops["rad_source_lane"][0]
    with pytest.raises(TypeError, match="float32"):
        rad_source_lane(*(x.double() for x in src), umu)
    (cppl, cpml, r1, r2, mu0, tab), _ = ops["eig_beam_chain_lane"]
    with pytest.raises(TypeError, match="float32"):
        eig_beam_chain_n2(*(x[None].double() for x in (cppl, cpml, r1, r2)),
                          mu0.double(), tab)


def _generic(nstr, nbc, nlyr, device, **kw):
    import chip_smoke

    return chip_smoke.generic_kernel_operands(*chip_smoke.generic_problem(
        nbc, 1, nlyr, device, nstr=nstr, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("nstr", [4, 8, 12, 16])
@pytest.mark.parametrize("lanes", [None, 130])
def test_eig_chain_kernel_matches_plain(cuda_device, nstr, lanes):
    """B9 on the generic path's all-mode operands (nstr modes x 9 layers x
    64 columns: N = 2, 4, 6, 8) and on their first 130 lanes, equal to its
    plain version element for element."""
    from sbdart_tpu_torch.kernels.eig_chain import (
        eig_chain, eig_chain_plain)

    (cppl, cpml, mu, w), _ = _generic(nstr, 64, 9, cuda_device,
                                      onlyfl=False)["eig_chain_lane"]
    ops = tuple(x[None, ..., :lanes].contiguous() for x in (cppl, cpml))
    before = launches(eig_chain)
    got = eig_chain(*ops, mu, w)
    torch.cuda.synchronize()
    assert launches(eig_chain) == before + 1
    for name, g, w_ in zip(NAMES, got, eig_chain_plain(*ops, mu, w)):
        _assert_equal(g, w_, name)


@pytest.mark.cuda
@pytest.mark.parametrize("nstr", [8, 12, 16])
@pytest.mark.parametrize("layout", ["layered", "flat"])
@pytest.mark.parametrize("lanes", [6144, 130])
def test_eig_chain_group_matches_plain(cuda_device, nstr, layout, lanes):
    """B9 at N = 4, 6, 8 runs the lane-group chain (B4's kernel without
    the beam solve), equal to its plain version element for element with
    a NaN in one lane's C^pp (NaN where the plain version has NaN): on
    the flux path's layered operands (33 layers x lanes) and on the
    generic path's flat all-mode lanes (a one-layer view, their first
    `lanes`)."""
    from sbdart_tpu_torch.kernels.eig_chain import (
        chain_entry, eig_chain, eig_chain_plain)

    if layout == "layered":
        front, _ = _general(lanes, nstr, cuda_device)
        cppl, cpml, mu, w = front[0], front[1], front[5], front[6]
    else:
        (cppl, cpml, mu, w), _ = _generic(nstr, 384, 9, cuda_device,
                                          onlyfl=False)["eig_chain_lane"]
        cppl, cpml = (x[None, ..., :lanes].contiguous() for x in (cppl, cpml))
    assert chain_entry(nstr // 2) == "sbdart_eig_chain_group"
    ops = (_nan_column(cppl, cppl.shape[-1] // 2), cpml)
    before = launches(eig_chain)
    got = eig_chain(*ops, mu, w)
    torch.cuda.synchronize()
    assert launches(eig_chain) == before + 1
    for name, g, w_ in zip(NAMES, got, eig_chain_plain(*ops, mu, w)):
        _assert_equal(g, w_, name)
    assert bool(torch.isnan(got[0]).any())


@pytest.mark.cuda
@pytest.mark.parametrize("nstr", [2, 4, 6, 8, 10, 12, 14, 16])
@pytest.mark.parametrize("cols", [None, 130])
def test_block_thomas_kernel_matches_plain(cuda_device, nstr, cols):
    """B10 on the blocks solver/bvp.py:assemble_blocks builds from the
    generic path's all-mode BVP (m = nstr = 2 .. 16, 9 layers, 130
    band-columns x nstr modes), and on the first 130 columns, equal to
    its plain version element for element."""
    from sbdart_tpu_torch.kernels.blocktri import (
        block_thomas, block_thomas_group, block_thomas_plain)
    from sbdart_tpu_torch.solver.bvp import assemble_blocks

    (gp, gm, ee, refl, rhs), _ = _generic(nstr, 130, 9, cuda_device,
                                          onlyfl=False)["solve_bvp"]
    # a float32 beam solve at an exact resonance (k = 1/mu0, the 0.5 dither
    # of a column without beam) leaves a column's rhs non-finite, on the
    # reference's route too (ROADMAP Queue C): hold only finite columns
    keep = torch.isfinite(rhs).all(dim=0).all(dim=0)
    ops = tuple(x[..., keep][..., :cols].contiguous()
                for x in (*assemble_blocks(gp, gm, ee, refl), rhs))
    before = launches(block_thomas) + launches(block_thomas_group)
    got = block_thomas(*ops)
    torch.cuda.synchronize()
    assert launches(block_thomas) + launches(block_thomas_group) == before + 1
    _assert_equal(got, block_thomas_plain(*ops), "xs")


def _dense_blocks(m, nlyr, ncol, device, seed=0):
    """Random B10 operands on the card (diag, lower, upper, rhs), the
    diagonally dominant systems of tests/test_torch_block_thomas.py, with
    a NaN in one column's right-hand side (chip_smoke.with_nan's
    pattern)."""
    import chip_smoke

    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    eye = torch.eye(m, device=device)[None, :, :, None]
    return chip_smoke.with_nan((randn(nlyr, m, m, ncol) + 4.0 * eye,
                                0.3 * randn(nlyr, m, m, ncol),
                                0.3 * randn(nlyr, m, m, ncol),
                                randn(nlyr, m, ncol)))


BT_M = [2, 4, 6, 7, 8, 10, 12, 14, 16, 18, 20]


@pytest.mark.cuda
@pytest.mark.parametrize("m", BT_M)
@pytest.mark.parametrize("ncol", [4096, 130])
def test_block_thomas_group_matches_plain(cuda_device, m, ncol):
    """B10's group kernel at every even m from 2 to 20 and at m = 7 (its
    rows instance, its instance per m, m a run-time argument), 33 layers,
    equal to its plain version element for element, NaN column
    included."""
    from sbdart_tpu_torch.kernels.blocktri import (
        block_thomas_group, block_thomas_plain)

    ops = _dense_blocks(m, 33, ncol, cuda_device)
    before = launches(block_thomas_group)
    got = block_thomas_group(*ops)
    torch.cuda.synchronize()
    assert launches(block_thomas_group) == before + 1
    _assert_equal(got, block_thomas_plain(*ops), "xs")
    assert bool(torch.isnan(got).any())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 4, 6, 8, 10, 12, 14, 16, 18])
def test_block_thomas_routes_each_m(cuda_device, m):
    """B10 through block_thomas's route at each m in and out of
    BT_ONE_THREAD_M (33 layers x 130 columns): the launch counters show
    the body thomas_entry names ran, equal to the plain version."""
    from sbdart_tpu_torch.kernels.blocktri import (
        block_thomas, block_thomas_group, block_thomas_plain, thomas_entry)

    ops = _dense_blocks(m, 33, 130, cuda_device)
    before = (launches(block_thomas), launches(block_thomas_group))
    got = block_thomas(*ops)
    torch.cuda.synchronize()
    one = thomas_entry(m) == "sbdart_block_thomas"
    assert (launches(block_thomas), launches(block_thomas_group)) == (
        before[0] + one, before[1] + (not one))
    _assert_equal(got, block_thomas_plain(*ops), "xs")


@pytest.mark.cuda
@pytest.mark.parametrize("nstr", [2, 6, 10, 14])
@pytest.mark.parametrize("cols", [None, 130])
def test_bvp_kernels_at_odd_n_match_plain(cuda_device, nstr, cols):
    """B5 and B6 at odd N = 1, 3, 5, 7 on the generic path's flux BVP
    (9 layers, 640 band-columns) and on its first 130 columns."""
    from sbdart_tpu_torch.kernels.blocktri_rt import (
        block_thomas_rt, block_thomas_rt_plain)
    from sbdart_tpu_torch.kernels.blocktri_rt_streamed import (
        block_thomas_rt_bwd, block_thomas_rt_bwd_plain, block_thomas_rt_fwd,
        block_thomas_rt_fwd_plain)

    bvp, _ = _generic(nstr, 640, 9, cuda_device, onlyfl=True)["solve_bvp"]
    ops = tuple(x[..., :cols].contiguous() for x in bvp)
    before = (_rt_launches(), _fwd_launches(), _bwd_launches())
    got = block_thomas_rt(*ops)
    cs, ys = block_thomas_rt_fwd(*ops)
    cs_p, ys_p = block_thomas_rt_fwd_plain(*ops)
    xs = block_thomas_rt_bwd(*ops[:3], cs_p, ys_p)
    torch.cuda.synchronize()
    assert (_rt_launches(), _fwd_launches(),
            _bwd_launches()) == tuple(b + 1 for b in before)
    _assert_close(got, block_thomas_rt_plain(*ops), "xs (B5)")
    _assert_close(cs, cs_p, "cs")
    _assert_close(ys, ys_p, "ys")
    _assert_close(xs, block_thomas_rt_bwd_plain(*ops[:3], cs_p, ys_p), "xs")


@pytest.mark.cuda
@pytest.mark.parametrize("nstr,kw,kernel,bvp", [
    (6, dict(onlyfl=True, planck=True), "block_thomas_rt", "auto"),
    (10, dict(onlyfl=False, angles=True), "block_thomas_rt", "auto"),
    (8, dict(onlyfl=False), "eig_chain", "auto"),
    (4, dict(onlyfl=False), "eig_chain", "auto"),
    (8, dict(onlyfl=True, brdf=True), "eig_beam_chain", "auto"),
    (8, dict(onlyfl=False), "block_thomas", "scan"),
])
def test_generic_solve_kernels_match_plain(cuda_device, nstr, kw, kernel,
                                           bvp):
    """solve_rte on the generic path in float32 through the kernels
    against its plain path on the card, 130 band-columns x 9 layers:
    every field within chip_smoke's 5e-4 of its max, and the named
    kernel launched (B10 on the bvp_method="scan" route)."""
    import importlib

    import chip_smoke
    from sbdart_tpu_torch.solver.disort import solve_rte

    module = {"block_thomas_rt": "blocktri_rt", "eig_chain": "eig_chain",
              "eig_beam_chain": "eig_beam", "block_thomas": "blocktri"}[kernel]
    if kernel == "block_thomas_rt":
        count = _rt_launches
    elif kernel == "block_thomas":
        from sbdart_tpu_torch.kernels.blocktri import (
            block_thomas, block_thomas_group)

        def count():   # B10's two designs (BT_ONE_THREAD_M)
            return launches(block_thomas) + launches(block_thomas_group)
    else:
        wrapper = getattr(importlib.import_module(
            f"sbdart_tpu_torch.kernels.{module}"), kernel)

        def count():
            return launches(wrapper)
    args, kw = chip_smoke.generic_problem(130, 1, 9, cuda_device, nstr=nstr,
                                          **kw)
    before = count()
    got = solve_rte(*args, dtype=torch.float32, bvp_method=bvp, **kw)
    want = solve_rte(*args, dtype=torch.float32, eig_method="plain",
                     bvp_method=bvp, **kw)
    assert count() > before
    for name in ("uu", "rfldir", "rfldn", "flup", "uavg", "dfdt"):
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
            continue
        assert torch.isfinite(g).all(), name
        err = float((g - w).abs().max() / w.abs().max().clamp_min(1e-9))
        assert err <= chip_smoke.E2E_BAR, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("nstr,f64_bar", [(18, 1e-2), (40, None)])
def test_generic_kernels_refuse_float64_and_run_n_above_8(cuda_device, nstr,
                                                          f64_bar):
    """The generic path's kernels refuse float64; float32 nstr=18 and 40
    run on the card (B5's group kernel at N = 9 and 20), the kernel path
    equal to the plain path; at nstr=18 the fluxes sit within 1e-2 of the
    float64 route's (of each field's max).  At nstr=40 these random optics
    leave the float32 route itself 0.13 of rfldn's max from float64 (the
    plain path alike), so it is held to the plain path only.  A float32
    beam resonance gives such gaps: where |k mu0 - 1| is at float32's
    rounding in a layer, the reference's float32 route is off too
    (tests/test_torch_generic_f32.py holds the port no further from
    float64 than the reference at nstr=40)."""
    from sbdart_tpu_torch.kernels.blocktri import block_thomas
    from sbdart_tpu_torch.kernels.blocktri_rt import block_thomas_rt_group
    from sbdart_tpu_torch.kernels.eig_chain import eig_chain
    from sbdart_tpu_torch.solver.bvp import assemble_blocks
    from sbdart_tpu_torch.solver.disort import solve_rte

    ops = _generic(8, 13, 5, cuda_device, onlyfl=False)
    (cppl, cpml, mu, w), _ = ops["eig_chain_lane"]
    with pytest.raises(TypeError, match="float32"):
        eig_chain(cppl[None].double(), cpml[None].double(), mu, w)
    (gp, gm, ee, refl, rhs), _ = ops["solve_bvp"]
    blocks = (*assemble_blocks(gp, gm, ee, refl), rhs)
    with pytest.raises(TypeError, match="float32"):
        block_thomas(*(x.double() for x in blocks))
    import chip_smoke

    args, kw = chip_smoke.generic_problem(13, 1, 5, cuda_device, nstr=nstr,
                                          onlyfl=True)
    before = launches(block_thomas_rt_group)
    out32 = solve_rte(*args, dtype=torch.float32, **kw)
    assert launches(block_thomas_rt_group) == before + 1
    plain = solve_rte(*args, dtype=torch.float32, eig_method="plain", **kw)
    out64 = solve_rte(*args, dtype=torch.float64, **kw)
    for name in ("rfldn", "flup", "uavg", "dfdt"):
        a = getattr(out32, name)
        assert torch.isfinite(a).all(), name
        assert torch.equal(a, getattr(plain, name)), name
        if f64_bar is not None:
            b = getattr(out64, name)
            err = float((a.double() - b).abs().max() / b.abs().max())
            assert err <= f64_bar, (name, err)


def _bvp_operands(n, nlyr, ncol, device, seed=0):
    """Random B5/B6 operands on the card (gp, gm, ee, refl, rhs), the
    systems of tests/test_torch_block_thomas.py's assembled-block case, with
    a NaN in one column's right-hand side (as the float32 beam resonance of
    ROADMAP Queue C leaves one)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    eye = torch.eye(n, device=device)[None, :, :, None]
    gm = 2.0 * eye + 0.3 * torch.randn((nlyr, n, n, ncol), generator=gen,
                                       device=device)
    gp = 0.4 * torch.randn((nlyr, n, n, ncol), generator=gen, device=device)
    ee = u(0.05, 0.8, nlyr, n, ncol)
    refl = u(0.0, 0.3, n, n, ncol)
    rhs = torch.randn((nlyr, 2 * n, ncol), generator=gen, device=device)
    rhs[min(1, nlyr - 1), 0, ncol // 2] = float("nan")
    return gp, gm, ee, refl, rhs


def _assert_equal(got, want, name):
    """Bit for bit, NaN where the plain version has NaN."""
    assert got.shape == want.shape, name
    torch.testing.assert_close(got, want, rtol=0.0, atol=0.0, equal_nan=True,
                               msg=name)


GROUP_N = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 16, 20]


@pytest.mark.cuda
@pytest.mark.parametrize("n", GROUP_N)
@pytest.mark.parametrize("ncol", [6144, 130])
def test_group_bvp_kernels_match_plain(cuda_device, n, ncol):
    """The group-per-column kernels against their plain versions, to the
    bit with the NaN column's NaN positions: B6 forward and backward at
    65 layers, B5 at 33 layers, B10 on the assembled blocks at 33 layers
    (m = 2N)."""
    from sbdart_tpu_torch.kernels import blocktri_rt_streamed as b6
    from sbdart_tpu_torch.kernels.blocktri import (
        block_thomas_group, block_thomas_plain)
    from sbdart_tpu_torch.kernels.blocktri_rt import (
        block_thomas_rt_group, block_thomas_rt_plain)
    from sbdart_tpu_torch.solver.bvp import assemble_blocks

    ops = _bvp_operands(n, 65, ncol, cuda_device)
    cs, ys = b6.block_thomas_rt_fwd_group(*ops)
    cs_p, ys_p = b6.block_thomas_rt_fwd_plain(*ops)
    before = launches(b6.block_thomas_rt_bwd_group)
    xs = b6.block_thomas_rt_bwd_group(*ops[:3], cs_p, ys_p)
    torch.cuda.synchronize()
    assert launches(b6.block_thomas_rt_bwd_group) == before + 1
    _assert_equal(cs, cs_p, "cs")
    _assert_equal(ys, ys_p, "ys")
    _assert_equal(xs, b6.block_thomas_rt_bwd_plain(*ops[:3], cs_p, ys_p),
                  "xs (B6)")
    assert bool(torch.isnan(ys).any()) and not bool(torch.isnan(cs).any())
    gp, gm, ee, refl, rhs = ops
    ops = (gp[:33].contiguous(), gm[:33].contiguous(), ee[:33].contiguous(),
           refl, rhs[:33].contiguous())
    before = launches(block_thomas_rt_group)
    got = block_thomas_rt_group(*ops)
    torch.cuda.synchronize()
    assert launches(block_thomas_rt_group) == before + 1
    _assert_equal(got, block_thomas_rt_plain(*ops), "xs (B5)")
    blocks = tuple(x.contiguous() for x in (*assemble_blocks(*ops[:4]),
                                            ops[4]))
    before = launches(block_thomas_group)
    got = block_thomas_group(*blocks)
    torch.cuda.synchronize()
    assert launches(block_thomas_group) == before + 1
    _assert_equal(got, block_thomas_plain(*blocks), "xs (B10)")


def _first_refused(column_bytes, optin, start=1):
    """The first size whose column_bytes exceed the card's opt-in shared
    memory a block."""
    size = start
    while column_bytes(size) <= optin:
        size += 1
    return size


def _group_limits(device):
    """{kernel: (first N or m refused with every region in shared memory,
    first refused with only the system there)} from the kernels' *_bytes
    entry points and the card's opt-in limit."""
    from sbdart_tpu_torch.kernels import _build

    lib = _build.library()
    optin = torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin
    rt, st, bt = (lib.sbdart_blocktri_rt_group_bytes,
                  lib.sbdart_blocktri_rt_streamed_group_bytes,
                  lib.sbdart_block_thomas_group_bytes)
    return {
        "b5": tuple(_first_refused(lambda n, f=f: rt(n, f), optin)
                    for f in (0, 1)),
        "b6": tuple(_first_refused(lambda n, k=k: st(k, n), optin)
                    for k in (0, 2)),
        "b10": tuple(_first_refused(lambda m, f=f: bt(m, f), optin)
                     for f in (0, 1)),
    }


def _group_case(kernel, size, device, ncol=3):
    """Run one group kernel at N (m for B10) = size on 3 layers x ncol
    columns with the NaN column, against its plain version."""
    from sbdart_tpu_torch.kernels import blocktri_rt_streamed as b6
    from sbdart_tpu_torch.kernels.blocktri import (
        block_thomas_group, block_thomas_plain)
    from sbdart_tpu_torch.kernels.blocktri_rt import (
        block_thomas_rt_group, block_thomas_rt_plain)
    from sbdart_tpu_torch.solver.bvp import assemble_blocks

    if kernel == "b5":
        ops = _bvp_operands(size, 3, ncol, device)
        got = block_thomas_rt_group(*ops)
        torch.cuda.synchronize()
        _assert_equal(got, block_thomas_rt_plain(*ops), "xs (B5)")
    elif kernel == "b6":
        ops = _bvp_operands(size, 3, ncol, device)
        cs, ys = b6.block_thomas_rt_fwd_group(*ops)
        cs_p, ys_p = b6.block_thomas_rt_fwd_plain(*ops)
        xs = b6.block_thomas_rt_bwd_group(*ops[:3], cs_p, ys_p)
        torch.cuda.synchronize()
        _assert_equal(cs, cs_p, "cs")
        _assert_equal(ys, ys_p, "ys")
        _assert_equal(xs, b6.block_thomas_rt_bwd_plain(*ops[:3], cs_p, ys_p),
                      "xs (B6)")
        got = ys
    else:
        ops = _bvp_operands(size // 2, 3, ncol, device)
        blocks = tuple(x.contiguous() for x in (*assemble_blocks(*ops[:4]),
                                                ops[4]))
        got = block_thomas_group(*blocks)
        torch.cuda.synchronize()
        _assert_equal(got, block_thomas_plain(*blocks), "xs (B10)")
    assert bool(torch.isnan(got).any())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["b5", "b6", "b10"])
def test_group_kernels_refuse_past_shared_memory(cuda_device, kernel):
    """Past the N whose whole column fills the card's opt-in shared memory
    (the first refused before the far placement), each group kernel runs
    its far instance -- the system in shared memory, the rest in device
    scratch -- and equals its plain version, NaN column included: at that
    first refused N and at nstr = 128 (N = 64; m = 128 for B10).  The
    wrappers refuse only where the system alone does not fit, naming the
    limit."""
    from sbdart_tpu_torch.kernels import blocktri_rt_streamed as b6
    from sbdart_tpu_torch.kernels.blocktri import block_thomas_group
    from sbdart_tpu_torch.kernels.blocktri_rt import block_thomas_rt_group
    from sbdart_tpu_torch.solver.bvp import assemble_blocks

    old, new = _group_limits(cuda_device)[kernel]
    nstr128 = 128 if kernel == "b10" else 64
    assert old <= nstr128 < new
    for size in (old + (old % 2 if kernel == "b10" else 0), nstr128):
        _group_case(kernel, size, cuda_device)
    what = "m" if kernel == "b10" else "N"
    ops = _bvp_operands(new // 2 + 1 if kernel == "b10" else new, 2, 1,
                        cuda_device)
    with pytest.raises(ValueError, match=f"shared memory.*{what} up to "):
        if kernel == "b5":
            block_thomas_rt_group(*ops)
        elif kernel == "b6":
            b6.block_thomas_rt_fwd_group(*ops)
        else:
            block_thomas_group(*assemble_blocks(*ops[:4]), ops[4])


@pytest.mark.cuda
@pytest.mark.parametrize("bvp_method", ["auto", "scan"])
def test_solve_rte_f32_runs_nstr128(cuda_device, bvp_method):
    """float32 solve_rte at nstr = 128 on the card, flux-only, 3 layers x 2
    band-columns: the streamed route (B6's far forward instance and its
    backward kernel) and bvp_method="scan" (B10's far instance), equal to
    the plain path field for field."""
    import chip_smoke
    from sbdart_tpu_torch.kernels import blocktri_rt_streamed as b6
    from sbdart_tpu_torch.kernels.blocktri import block_thomas_group
    from sbdart_tpu_torch.solver.disort import solve_rte

    args, kw = chip_smoke.generic_problem(2, 1, 3, cuda_device, nstr=128,
                                          onlyfl=True)
    counter = (block_thomas_group if bvp_method == "scan"
               else b6.block_thomas_rt_fwd_group)
    before = launches(counter)
    got = solve_rte(*args, dtype=torch.float32, bvp_method=bvp_method, **kw)
    assert launches(counter) == before + 1
    want = solve_rte(*args, dtype=torch.float32, eig_method="plain",
                     bvp_method=bvp_method, **kw)
    for name in ("rfldir", "rfldn", "flup", "uavg", "dfdt"):
        g = getattr(got, name)
        assert torch.isfinite(g).all(), name
        assert torch.equal(g, getattr(want, name)), name


def _rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.cuda
def test_slab_albedo_transmission_kernels_match_plain(cuda_device):
    """ibcnd=1 at nstr=4 in float32 (B1 and B2 on the fluxlane route),
    against the plain path on the card: 64 spectral samples x 3 incidence
    cosines x 32 layers, within 5e-4 of each field's max."""
    from sbdart_tpu_torch.kernels.blocktri_n2 import block_thomas_rt_n2
    from sbdart_tpu_torch.kernels.eig_n2 import eig_beam_deltam_scatter_n2
    from sbdart_tpu_torch.solver.albtrn import slab_albedo_transmission

    rng = np.random.default_rng(0)
    dtau = rng.uniform(0.001, 1.0, (64, 32))
    ssalb = rng.uniform(0.3, 1.0, (64, 32))
    pmom = rng.uniform(0.0, 0.8, (64, 32, 1)) ** np.arange(5)
    umu = np.cos(np.deg2rad([0.0, 45.0, 75.0]))
    kw = dict(nstr=4, umu=umu, albedo=0.1, dtype=torch.float32,
              device=cuda_device)
    before = (launches(eig_beam_deltam_scatter_n2),
              launches(block_thomas_rt_n2))
    got = slab_albedo_transmission(dtau, ssalb, pmom, **kw)
    torch.cuda.synchronize()
    assert (launches(eig_beam_deltam_scatter_n2),
            launches(block_thomas_rt_n2)) == tuple(b + 1 for b in before)
    want = slab_albedo_transmission(dtau, ssalb, pmom, eig_method="plain",
                                    **kw)
    for g, w in zip(got, want):
        assert g.shape == (64, 3)
        assert _rel_err(g.cpu(), w.cpu()) <= 5e-4


BATCH_CFG = dict(idatm=2, wlinf=1.5, wlsup=4.0, wlinc=0.05, nstr=4,
                 albcon=0.2, tcloud=[5.0, 0, 0, 0, 0],
                 zcloud=[2.0, 0, 0, 0, 0], iaer=1)


def _batch(n=64):
    from sbdart_tpu_torch.batch import ColumnBatch

    rng = np.random.default_rng(0)
    return ColumnBatch(csza=rng.uniform(0.2, 1.0, n),
                       gas_scale=rng.uniform(0.8, 1.2, n),
                       cld_scale=rng.uniform(0.5, 1.5, n),
                       aer_scale=rng.uniform(0.5, 1.5, n),
                       albedo_scale=rng.uniform(0.5, 1.5, n))


@pytest.mark.cuda
def test_run_batch_kernels_match_plain(cuda_device):
    """run_batch in float32 with the Planck source on (the band crosses
    2 um: B3 and B2 on every chunk), 64 perturbed columns in chunks of 32,
    against the plain path on the card within 5e-4 of each field's max."""
    from sbdart_tpu_torch.batch import run_batch
    from sbdart_tpu_torch.config import Config
    from sbdart_tpu_torch.kernels.blocktri_n2 import block_thomas_rt_n2
    from sbdart_tpu_torch.kernels.eig_n2_scatter import eig_beam_scatter_n2

    kw = dict(band_chunk=8, col_chunk=32, dtype=torch.float32,
              device=cuda_device)
    before = (launches(eig_beam_scatter_n2), launches(block_thomas_rt_n2))
    got = run_batch(Config(**BATCH_CFG), _batch(), **kw)
    nsolve = 2 * -(-51 // 8)            # 2 column chunks x 7 band chunks
    assert (launches(eig_beam_scatter_n2),
            launches(block_thomas_rt_n2)) == tuple(b + nsolve for b in before)
    want = run_batch(Config(**BATCH_CFG), _batch(), eig_method="plain", **kw)
    for field in ("fdir", "fdn", "fup"):
        assert _rel_err(getattr(got, field), getattr(want, field)) <= 5e-4


@pytest.mark.cuda
def test_run_batch_world_of_one_nccl_equals_single_run(cuda_device,
                                                       tmp_path):
    """init_distributed on NCCL with a world of one: run_batch through the
    process-group route (one all-reduce, one all-gather) equals the run
    without a process group to the bit."""
    import torch.distributed as dist

    from sbdart_tpu_torch.batch import run_batch
    from sbdart_tpu_torch.config import Config
    from sbdart_tpu_torch.sharding import init_distributed, make_mesh

    kw = dict(band_chunk=8, col_chunk=48, dtype=torch.float32,
              device=cuda_device)
    single = run_batch(Config(**BATCH_CFG), _batch(), **kw)
    init_distributed(f"file://{tmp_path / 'init'}", 1, 0, backend="nccl")
    try:
        assert dist.get_backend() == "nccl"
        mesh = make_mesh(1)
        assert mesh.distributed
        grouped = run_batch(Config(**BATCH_CFG), _batch(), mesh=mesh, **kw)
    finally:
        dist.destroy_process_group()
    for field in ("fdir", "fdn", "fup"):
        np.testing.assert_array_equal(getattr(grouped, field),
                                      getattr(single, field))


@pytest.mark.cuda
def test_run_batch_nccl_world_of_one_resume_equals_first_run(cuda_device,
                                                             tmp_path):
    """The NCCL world of one with a checkpoint directory (chip_smoke's
    distributed phase): the first run equals the run without a process
    group to the bit; a resume from every checkpoint, after the agreement
    collective on NCCL, equals it and launches no kernel; a poisoned file
    shows; once it is deleted its chunk alone is recomputed, equal again."""
    import os

    import torch.distributed as dist

    from sbdart_tpu_torch.batch import run_batch
    from sbdart_tpu_torch.config import Config
    from sbdart_tpu_torch.kernels.blocktri_n2 import block_thomas_rt_n2
    from sbdart_tpu_torch.sharding import init_distributed, make_mesh

    kw = dict(band_chunk=8, col_chunk=32, dtype=torch.float32,
              device=cuda_device)
    single = run_batch(Config(**BATCH_CFG), _batch(), **kw)
    ck = str(tmp_path / "ck")
    first = os.path.join(ck, "cols_0_32.npz")
    init_distributed(f"file://{tmp_path / 'init'}", 1, 0, backend="nccl")
    try:
        assert dist.get_backend() == "nccl"
        mesh = make_mesh(1)

        def run():
            n0 = launches(block_thomas_rt_n2)
            res = run_batch(Config(**BATCH_CFG), _batch(), mesh=mesh,
                            checkpoint_dir=ck, **kw)
            return res, launches(block_thomas_rt_n2) - n0

        grouped, n_first = run()
        resumed, n_resume = run()
        with np.load(first) as z:
            arrays = {f: z[f] for f in ("fdir", "fdn", "fup")}
        np.savez(first, **{**arrays, "fdir": arrays["fdir"] * 0 + 7.0})
        poisoned, _ = run()
        os.remove(first)
        recomputed, n_recompute = run()
    finally:
        dist.destroy_process_group()
    assert n_first > 0 and n_resume == 0 and 2 * n_recompute == n_first
    np.testing.assert_array_equal(poisoned.fdir[:32], 7.0)
    np.testing.assert_array_equal(poisoned.fdir[32:], single.fdir[32:])
    for res in (grouped, resumed, recomputed):
        for field in ("fdir", "fdn", "fup"):
            np.testing.assert_array_equal(getattr(res, field),
                                          getattr(single, field))


@pytest.mark.cuda
def test_local_rank_refuses_past_the_cards(cuda_device, monkeypatch):
    """Without LOCAL_RANK, a process id names a card only below the real
    card count; at it, a ValueError."""
    from sbdart_tpu_torch.sharding import _local_rank

    monkeypatch.delenv("LOCAL_RANK", raising=False)
    n = torch.cuda.device_count()
    assert _local_rank(n - 1) == n - 1
    with pytest.raises(ValueError, match=f"LOCAL_RANK is unset and process "
                                         f"{n} names no card"):
        _local_rank(n)
