"""The radiance helpers of the lane path (solver/radiance.py): the
Nakajima-Tanaka TMS and IMS corrections and the secondary-scattering
function xi against the JAX package's, in float64, at 1e-12 of each
output's max.

Inputs: 4 layers x 3 columns of random optics (dtau U(0.001, 0.6),
ssalb U(0.05, 0.999), Henyey-Greenstein moments of g U(0.5, 0.9) to 33
moments so that delta-M truncates a real forward peak), delta-M at
nstr = 8, a beam in two of the three columns, phi0 = 10, user cosines of
both signs (one at -mu0 of a column: the aureole) and 3 azimuths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbdart_tpu.solver import radiance as ref_radiance
from sbdart_tpu.solver.deltam import apply_deltam as ref_apply_deltam
from sbdart_tpu_torch.solver import radiance
from sbdart_tpu_torch.solver.deltam import apply_deltam

NSTR = 8
PHI = np.array([0.0, 90.0, 200.0])


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    nbc, nlyr = 3, 4
    dtau = rng.uniform(0.001, 0.6, (nbc, nlyr))
    ssalb = rng.uniform(0.05, 0.999, (nbc, nlyr))
    g = rng.uniform(0.5, 0.9, (nbc, nlyr))
    pmom = g[..., None] ** np.arange(33)
    fbeam = np.array([1.0, 0.0, 2.0])
    mu0 = np.array([0.6, 0.5, 0.8])
    umu = np.array([0.3, 0.9, -0.6, -0.95])
    return dtau, ssalb, pmom, fbeam, mu0, umu


def _both(seed=0):
    dtau, ssalb, pmom, fbeam, mu0, umu = _inputs(seed)

    def sides(dm, tau_of, lib, t):
        tau_s = tau_of(dm.dtau)
        tau_u = tau_of(dm.dtau_unscaled)
        eb = lib.exp(-tau_s / t(mu0)[:, None])
        return dict(dm=dm, pmom_unscaled=t(pmom), expbea_s=eb,
                    fbeam=t(fbeam), mu0=t(mu0), phi0=t(np.full(3, 10.0)),
                    umu=umu, phi=PHI, nstr=NSTR), tau_s, tau_u

    def j(x):
        return jnp.asarray(x, jnp.float64)

    def tau_j(d):
        return jnp.concatenate([jnp.zeros_like(d[:, :1]),
                                jnp.cumsum(d, axis=-1)], axis=-1)

    def tau_t(d):
        return torch.cat([torch.zeros_like(d[:, :1]),
                          torch.cumsum(d, dim=-1)], dim=-1)

    ref_kw, ref_ts, ref_tu = sides(
        ref_apply_deltam(j(dtau), j(ssalb), j(pmom), NSTR, True), tau_j,
        jnp, j)
    got_kw, got_ts, got_tu = sides(
        apply_deltam(*(torch.from_numpy(x) for x in (dtau, ssalb, pmom)),
                     NSTR, True), tau_t, torch, torch.from_numpy)
    ssalb_j, ssalb_t = j(ssalb), torch.from_numpy(ssalb)
    return (ref_kw, ref_ts, ref_tu, ssalb_j), (got_kw, got_ts, got_tu,
                                               ssalb_t)


def _close(got, want, rel=1e-12):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), \
        np.abs(got - want).max() / np.abs(want).max()


def test_tms_correction_matches_reference():
    (rk, rts, _, _), (gk, _, _, _) = _both()
    want = ref_radiance._tms_correction(tau_s=rts, dtype=jnp.float64, **rk)
    got = radiance._tms_correction(**gk)
    assert float(np.abs(np.asarray(want)).max()) > 0.0
    _close(got, want)


def test_ims_correction_matches_reference():
    (rk, _, rtu, rss), (gk, _, gtu, gss) = _both(seed=1)
    for kw in (rk, gk):
        del kw["expbea_s"]
    want = ref_radiance._ims_correction(
        ssalb_unscaled=rss, tau_u=rtu, dtype=jnp.float64, **rk)
    got = radiance._ims_correction(ssalb_unscaled=gss, tau_u=gtu, **gk)
    assert float(np.abs(np.asarray(want)).max()) > 0.0
    assert float(got[..., :2, :].abs().max()) == 0.0   # upward cosines
    _close(got, want)


@pytest.mark.parametrize("u2_minus_u1", [0.3, 1e-3, 1e-6, 0.0])
def test_xi_function_matches_reference(u2_minus_u1):
    """Away from, near (Taylor branch below |x1 max(u1, u2)| < 1e-4) and
    at the u1 -> u2 limit."""
    u1 = np.array([0.2, 0.5, 0.9])
    u2 = u1 + u2_minus_u1
    tau = np.array([0.01, 0.7, 3.0])
    want = ref_radiance.xi_function(*(jnp.asarray(x) for x in (u1, u2, u2,
                                                               tau)))
    got = radiance.xi_function(*(torch.from_numpy(x) for x in (u1, u2, u2,
                                                               tau)))
    _close(got, want)


@pytest.mark.parametrize("k", [0.4, 2.0, 1.0 / 0.7 * (1.0 + 1e-7)])
def test_path_integrals_match_reference(k):
    """_int_toward and _int_away, the latter also on its resonance
    (u k = 1 + 1e-7 at u = 0.7)."""
    kk = np.full(3, k)
    delta = np.array([0.01, 0.3, 2.0])
    u = 0.7
    for name in ("_int_toward", "_int_away"):
        want = getattr(ref_radiance, name)(jnp.asarray(kk), jnp.asarray(delta),
                                           u)
        got = getattr(radiance, name)(torch.from_numpy(kk),
                                      torch.from_numpy(delta), u)
        _close(got, want)


def test_legendre_at_matches_reference():
    x = np.linspace(-1.0, 1.0, 7)
    _close(radiance._legendre_at(torch.from_numpy(x), 40),
           ref_radiance._legendre_at(jnp.asarray(x), 40))
