"""B1 (fused nstr=4 front end): the port's plain torch version against the
JAX package's Pallas kernel run through the interpreter.

Both sides get the same NumPy inputs in float32.  Per-mode tensors are
compared directly: both routes order the modes by the chain's `wa <= wb`
select.

Two correct float32 evaluations of this chain do not agree to the last
bit: XLA's CPU backend contracts multiply-adds into FMAs (the dtau* plane
matches bit for bit once `1 - w f` is taken as an FMA) and torch does not.
Where the chain amplifies rounding (the conservative dither lanes, where
kk ~ sqrt(dither), and the half-angle eigenvector formulas) the two
routes then differ by more than the reference's interpret bar.  So:

  * the well-conditioned planes (dtau*, ee, and kk away from the
    conservative dither) are held at the reference's interpret bar,
    rtol 1e-5 / atol 1e-6 (tests/test_pallas_kernels.py:29,69);
  * every plane, at every lane, is held to the reference's own float32
    floor: against a float64 evaluation of the same algorithm (same
    float32 constants), the port's normwise error is at most twice the
    reference's (the form of the reference's own
    test_block_thomas_rt_f32_forward_error_at_conditioning_floor).
    Measured on CPU: both routes at 6.4e-3 (gp, gm), 1.3e-4 (zp, zm),
    7e-6 (kk) of each plane's max; port / reference ratio 0.95-1.41.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbdart_tpu.pallas.eig import eig_beam_deltam_scatter_n2_layered
from sbdart_tpu.solver.eig import angular_tables as ref_angular_tables
from sbdart_tpu_torch.kernels import eig_n2
from sbdart_tpu_torch.kernels.eig_n2 import (
    eig_beam_deltam_scatter_n2,
    eig_beam_deltam_scatter_n2_plain,
)
from sbdart_tpu_torch.solver.eig import angular_tables

NAMES = ("kk", "gp", "gm", "zp", "zm", "dtau_scaled", "ee")
CONSERVATIVE_COLS = np.zeros(130, bool)
CONSERVATIVE_COLS[::17] = True        # ssalb = 1 (clipped to 1 - dither)
CONSERVATIVE_COLS[5::19] = True       # ssalb = 0.99999


def front_problem(nlyr, b, seed=0):
    """Raw optics in scan layout: dtau U(0.001, 0.6), ssalb U(0.05, 0.999)
    with conservative (1.0) and near-conservative (0.99999) columns, HG
    moments of g U(0, 0.85), 20% of columns without a beam (mu0 = 0.5
    dither)."""
    rng = np.random.default_rng(seed)
    dtau = rng.uniform(0.001, 0.6, (nlyr, b))
    ssalb = rng.uniform(0.05, 0.999, (nlyr, b))
    ssalb[:, ::17] = 1.0
    ssalb[:, 5::19] = 0.99999
    g = rng.uniform(0.0, 0.85, (nlyr, b))
    pmom = g[:, None, :] ** np.arange(5)[None, :, None]
    beam = rng.uniform(size=b) < 0.8
    scale = np.where(beam, 1.0 / (2.0 * np.pi), 0.0)[None, :]
    mu0 = np.where(beam, rng.uniform(0.2, 1.0, b), 0.5)[None, :]
    return [x.astype(np.float32) for x in (dtau, ssalb, pmom, scale, mu0)]


def _both(use_deltam):
    args = front_problem(6, 130)        # unaligned lane count
    ref = eig_beam_deltam_scatter_n2_layered(
        *(jnp.asarray(a) for a in args), ref_angular_tables(4, 1),
        use_deltam=use_deltam, interpret=True,
    )
    got = eig_beam_deltam_scatter_n2_plain(
        *(torch.from_numpy(a) for a in args), angular_tables(4, 1),
        use_deltam=use_deltam,
    )
    ref = [np.asarray(r) for r in ref]
    got = [g.numpy() for g in got]
    for name, r, g in zip(NAMES, ref, got):
        assert g.shape == r.shape and g.dtype == np.float32, name
        assert np.isfinite(g).all(), name
    return args, ref, got


@pytest.mark.parametrize("use_deltam", [True, False])
def test_eig_n2_plain_matches_pallas_interpret(use_deltam):
    _, ref, got = _both(use_deltam)
    r = dict(zip(NAMES, ref))
    g = dict(zip(NAMES, got))
    for name in ("dtau_scaled", "ee"):
        np.testing.assert_allclose(g[name], r[name], rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    cols = ~CONSERVATIVE_COLS
    np.testing.assert_allclose(g["kk"][..., cols], r["kk"][..., cols],
                               rtol=1e-5, atol=1e-6, err_msg="kk")


@pytest.mark.parametrize("use_deltam", [True, False])
def test_eig_n2_plain_at_reference_f32_floor(use_deltam):
    args, ref, got = _both(use_deltam)
    consts32 = eig_n2._consts(angular_tables(4, 1), torch.float32)
    truth = eig_n2._front(
        consts32, *(torch.from_numpy(a).double() for a in args), use_deltam
    )
    for name, r, g, t in zip(NAMES, ref, got, truth):
        t = t.numpy()
        scale = np.abs(t).max()
        err_ref = np.abs(r - t).max() / scale
        err_got = np.abs(g - t).max() / scale
        assert err_got <= 2.0 * err_ref + 1e-7, (name, err_got, err_ref)


def test_eig_n2_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing, in float32 and float64 alike."""
    tab = angular_tables(4, 1)
    before = eig_beam_deltam_scatter_n2.launches
    for dtype in (torch.float32, torch.float64):
        args = [torch.from_numpy(a).to(dtype)
                for a in front_problem(3, 40, seed=1)]
        got = eig_beam_deltam_scatter_n2(*args, tab)
        want = eig_beam_deltam_scatter_n2_plain(*args, tab)
        for g, w in zip(got, want):
            assert g.dtype == dtype and torch.equal(g, w)
    assert eig_beam_deltam_scatter_n2.launches == before
