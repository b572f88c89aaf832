"""The port's CUDA kernels against their plain torch versions, on a card.

Marked `cuda`; skips where torch sees no CUDA device.  On a card (where
there is no JAX, so the repo conftest is left out):

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -o addopts=''

Bar: the reference's compiled-kernel bar, rtol 1e-4 / atol 1e-5
(tests/test_pallas_kernels.py:142), at the main path's shapes (B1/B2/B3:
33 layers x 49152 columns; B4/B5: 33 layers x 6144 columns at N = 4, 6
and 8; B6: 65 layers x 6144 columns at N = 4, 6 and 8) and an unaligned
130.  The kernels are built with --fmad=false and
follow their plain versions' operation order, so they agree to the last
bit on the H100 (B1/B2 measured max |error| 0.0, NVIDIA H100 80GB HBM3 at
700 W).
"""

import pytest
import torch


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
    before = eig_beam_deltam_scatter_n2.launches
    got = eig_beam_deltam_scatter_n2(*ops, tab, use_deltam=use_dm)
    torch.cuda.synchronize()
    assert eig_beam_deltam_scatter_n2.launches == before + 1
    want = eig_beam_deltam_scatter_n2_plain(*ops, tab, use_deltam=use_dm)
    for name, g, w in zip(NAMES + ("dts", "ee"), got, want):
        _assert_close(g, w, name)


@pytest.mark.cuda
@pytest.mark.parametrize("ncol", [49152, 130])
def test_blocktri_n2_kernel_matches_plain(cuda_device, ncol):
    from sbdart_tpu_torch.kernels.blocktri_n2 import (
        block_thomas_rt_n2, block_thomas_rt_n2_plain)

    _, _, _, ops = _problem(ncol, cuda_device)
    got = block_thomas_rt_n2(*ops)
    torch.cuda.synchronize()
    _assert_close(got, block_thomas_rt_n2_plain(*ops), "xs")


@pytest.mark.cuda
@pytest.mark.parametrize("ncol", [49152, 130])
def test_eig_n2_scatter_kernel_matches_plain(cuda_device, ncol):
    from sbdart_tpu_torch.kernels.eig_n2_scatter import (
        eig_beam_scatter_n2, eig_beam_scatter_n2_plain)

    ops, _ = _general(ncol, 4, cuda_device)
    before = eig_beam_scatter_n2.launches
    got = eig_beam_scatter_n2(*ops)
    torch.cuda.synchronize()
    assert eig_beam_scatter_n2.launches == before + 1
    for name, g, w in zip(NAMES, got, eig_beam_scatter_n2_plain(*ops)):
        _assert_close(g, w, name)


@pytest.mark.cuda
@pytest.mark.parametrize("nstr", [8, 12, 16])
@pytest.mark.parametrize("ncol", [6144, 130])
def test_eig_beam_kernel_matches_plain(cuda_device, nstr, ncol):
    from sbdart_tpu_torch.kernels.eig_beam import (
        eig_beam_chain, eig_beam_chain_plain)

    ops, _ = _general(ncol, nstr, cuda_device)
    before = eig_beam_chain.launches
    got = eig_beam_chain(*ops)
    torch.cuda.synchronize()
    assert eig_beam_chain.launches == before + 1
    for name, g, w in zip(NAMES, got, eig_beam_chain_plain(*ops)):
        _assert_close(g, w, name)


@pytest.mark.cuda
@pytest.mark.parametrize("nstr", [8, 12, 16])
@pytest.mark.parametrize("ncol", [6144, 130])
def test_blocktri_rt_kernel_matches_plain(cuda_device, nstr, ncol):
    from sbdart_tpu_torch.kernels.blocktri_rt import (
        block_thomas_rt, block_thomas_rt_plain)

    _, ops = _general(ncol, nstr, cuda_device)
    before = block_thomas_rt.launches
    got = block_thomas_rt(*ops)
    torch.cuda.synchronize()
    assert block_thomas_rt.launches == before + 1
    _assert_close(got, block_thomas_rt_plain(*ops), "xs")


@pytest.mark.cuda
@pytest.mark.parametrize("nstr", [8, 12, 16])
@pytest.mark.parametrize("ncol", [6144, 130])
def test_blocktri_rt_streamed_kernels_match_plain(cuda_device, nstr, ncol):
    """B6: the forward kernel against its plain version, the backward
    kernel against its plain version on the plain forward's history."""
    from sbdart_tpu_torch.kernels.blocktri_rt_streamed import (
        block_thomas_rt_bwd, block_thomas_rt_bwd_plain, block_thomas_rt_fwd,
        block_thomas_rt_fwd_plain)

    _, ops = _general(ncol, nstr, cuda_device, nlyr=65)
    before = (block_thomas_rt_fwd.launches, block_thomas_rt_bwd.launches)
    cs, ys = block_thomas_rt_fwd(*ops)
    cs_p, ys_p = block_thomas_rt_fwd_plain(*ops)
    xs = block_thomas_rt_bwd(*ops[:3], cs_p, ys_p)
    torch.cuda.synchronize()
    assert (block_thomas_rt_fwd.launches,
            block_thomas_rt_bwd.launches) == (before[0] + 1, before[1] + 1)
    _assert_close(cs, cs_p, "cs")
    _assert_close(ys, ys_p, "ys")
    _assert_close(xs, block_thomas_rt_bwd_plain(*ops[:3], cs_p, ys_p), "xs")


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
