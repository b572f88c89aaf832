"""The port's CUDA kernels against their plain torch versions, on a card.

Marked `cuda`; skips where torch sees no CUDA device.  On a card (where
there is no JAX, so the repo conftest is left out):

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -o addopts=''

Bar: the reference's compiled-kernel bar, rtol 1e-4 / atol 1e-5
(tests/test_pallas_kernels.py:142), at the main path's shape (33 layers x
49152 columns) and an unaligned 130.  The kernels are built with
--fmad=false and follow their plain versions' operation order, so they
agree to the last bit on the H100 (measured max |error| 0.0, NVIDIA H100
80GB HBM3 at 700 W).
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


def _assert_close(got, want, name):
    assert got.shape == want.shape, name
    assert torch.isfinite(got).all(), name
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5, msg=name)


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
    for name, g, w in zip(("kk", "gp", "gm", "zp", "zm", "dts", "ee"),
                          got, want):
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
def test_kernels_refuse_float64_on_card(cuda_device):
    from sbdart_tpu_torch.kernels.blocktri_n2 import block_thomas_rt_n2

    _, _, _, ops = _problem(130, cuda_device)
    with pytest.raises(TypeError, match="float32"):
        block_thomas_rt_n2(*(x.double() for x in ops))
