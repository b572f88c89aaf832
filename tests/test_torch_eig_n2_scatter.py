"""B3 (nstr=4 front end on delta-M-scaled optics): the port's plain torch
version against the JAX package's Pallas kernel run through the
interpreter, at the bars tests/test_torch_eig_n2.py sets for B1.

Both sides get the same float32 NumPy inputs: delta-M-scaled ssalb (with
conservative-dither and near-conservative columns) and 4 HG moments, the
beam scale and cosine.  Per-mode tensors are compared directly (both
routes order the modes by the chain's `wa <= wb` select):

  * kk away from the conservative dither at the reference's interpret bar
    rtol 1e-5 / atol 1e-6 (tests/test_pallas_kernels.py:29,69);
  * every plane, at every lane, no further from a float64 evaluation of
    the same algorithm (same float32 constants) than twice the
    reference's own distance (XLA's CPU backend contracts multiply-adds
    into FMAs and torch does not; see test_torch_eig_n2.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from launch_counts import launches

from sbdart_tpu.pallas.eig import eig_beam_scatter_n2_layered
from sbdart_tpu.solver.eig import angular_tables as ref_angular_tables
from sbdart_tpu_torch.kernels import eig_n2
from sbdart_tpu_torch.kernels.eig_n2_scatter import (
    eig_beam_scatter_n2,
    eig_beam_scatter_n2_plain,
)
from sbdart_tpu_torch.solver.deltam import ssalb_dither
from sbdart_tpu_torch.solver.eig import angular_tables

NAMES = ("kk", "gp", "gm", "zp", "zm")


def scatter_problem(nlyr, b, seed=0):
    """Delta-M-scaled optics in scan layout: ssalb U(0.05, 0.999) with
    columns at the float32 conservative clip (1 - dither) and at 0.99999,
    HG moments of g U(0, 0.85) (l = 0..3), 20% of columns without a beam
    (mu0 = 0.5 dither)."""
    rng = np.random.default_rng(seed)
    ssalb = rng.uniform(0.05, 0.999, (nlyr, b))
    cons = np.zeros(b, bool)
    cons[::17] = True
    ssalb[:, ::17] = 1.0 - ssalb_dither(torch.float32)
    ssalb[:, 5::19] = 0.99999
    g = rng.uniform(0.0, 0.85, (nlyr, b))
    gl = g[:, None, :] ** np.arange(4)[None, :, None]
    beam = rng.uniform(size=b) < 0.8
    scale = np.where(beam, 1.0 / (2.0 * np.pi), 0.0)[None, :]
    mu0 = np.where(beam, rng.uniform(0.2, 1.0, b), 0.5)[None, :]
    cons[5::19] = True
    return [x.astype(np.float32) for x in (ssalb, gl, scale, mu0)], cons


@pytest.fixture(scope="module", params=[16, 130], ids=["b16", "b130"])
def both(request):
    args, cons = scatter_problem(5, request.param)
    ref = eig_beam_scatter_n2_layered(
        *(jnp.asarray(a) for a in args), ref_angular_tables(4, 1),
        interpret=True)
    got = eig_beam_scatter_n2_plain(*(torch.from_numpy(a) for a in args),
                                    angular_tables(4, 1))
    ref = [np.asarray(r) for r in ref]
    got = [g.numpy() for g in got]
    for name, r, g in zip(NAMES, ref, got):
        assert g.shape == r.shape and g.dtype == np.float32, name
        assert np.isfinite(g).all(), name
    return args, cons, ref, got


def test_eig_n2_scatter_plain_matches_pallas_interpret(both):
    _, cons, ref, got = both
    np.testing.assert_allclose(got[0][..., ~cons], ref[0][..., ~cons],
                               rtol=1e-5, atol=1e-6, err_msg="kk")


def test_eig_n2_scatter_plain_at_reference_f32_floor(both):
    args, _, ref, got = both
    consts32 = eig_n2._consts(angular_tables(4, 1), torch.float32)
    ss, gl, scale, mu0 = (torch.from_numpy(a).double() for a in args)
    truth = eig_n2._scatter_chain(consts32, ss, [gl[:, q] for q in range(4)],
                                  scale, mu0)
    for name, r, g, t in zip(NAMES, ref, got, truth):
        t = t.numpy()
        scale_ = np.abs(t).max()
        err_ref = np.abs(r - t).max() / scale_
        err_got = np.abs(g - t).max() / scale_
        assert err_got <= 2.0 * err_ref + 1e-7, (name, err_got, err_ref)


def test_eig_n2_scatter_is_b1_without_deltam():
    """B3 equals B1 with delta-M off on optics inside B1's ssalb clip (B1
    clips the raw ssalb at 1 - dither; B3 takes scaled optics as given)."""
    args, _ = scatter_problem(3, 40, seed=1)
    ss, gl, scale, mu0 = (torch.from_numpy(a) for a in args)
    ss = torch.clamp(ss, max=1.0 - ssalb_dither(torch.float32))
    tab = angular_tables(4, 1)
    b1 = eig_n2.eig_beam_deltam_scatter_n2_plain(
        torch.full_like(ss, 0.3), ss,
        torch.cat([gl, torch.zeros_like(gl[:, :1])], dim=1), scale, mu0, tab,
        use_deltam=False)
    b3 = eig_beam_scatter_n2_plain(ss, gl, scale, mu0, tab)
    for name, a, b in zip(NAMES, b3, b1):
        assert torch.equal(a, b), name


def test_eig_n2_scatter_wrapper_takes_plain_version_on_cpu():
    tab = angular_tables(4, 1)
    before = launches(eig_beam_scatter_n2)
    for dtype in (torch.float32, torch.float64):
        args = [torch.from_numpy(a).to(dtype)
                for a in scatter_problem(3, 40, seed=2)[0]]
        got = eig_beam_scatter_n2(*args, tab)
        want = eig_beam_scatter_n2_plain(*args, tab)
        for g, w in zip(got, want):
            assert g.dtype == dtype and torch.equal(g, w)
    assert launches(eig_beam_scatter_n2) == before
