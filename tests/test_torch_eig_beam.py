"""B4 (general-n eigen chain + beam solve): the port's plain torch version
against the JAX package's layered Pallas kernel run through the
interpreter (eig_beam_chain_lane_fused_layered, interpret=True), at N = 4,
6 and 8 (nstr 8, 12 and 16), on the same float32 operands.

Operands come from the flux path's own head (solver/fluxlane.py:
general_operands) on random optics: ssalb U(0.05, 0.999) with one
near-conservative column (0.99999), HG moments of g U(0, 0.85), 20% of
columns without a beam.  Bars, the reference's own
(tests/test_pallas_kernels.py:189-263):

  * eigenpairs sorted by kk on both sides (neither route sorts): kk within
    5e-5 everywhere, G+- within 1e-3 off the near-conservative column
    (measured 2e-5 to 4.8e-4);
  * the eigen relations (alpha-beta) X = -k Y and (alpha+beta) Y = -k X
    with X = G+ + G-, Y = G+ - G-, against float64 operators: residual
    below 5e-4 of max |X| off the near-conservative column (mode-order
    free).  On that column float32 conditioning leaves 1e-2 to 1e-1 on
    both routes (the reference's own note, pallas/eig.py:378-391), and the
    port is held to twice the reference's residual there;
  * Z+- (mode-free) within 1e-4 of their largest magnitude (measured
    2.5e-5 at N = 8).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from launch_counts import launches

from sbdart_tpu.pallas.eig import eig_beam_chain_lane_fused_layered
from sbdart_tpu_torch.kernels.eig_beam import (
    eig_beam_chain,
    eig_beam_chain_plain,
)
from sbdart_tpu_torch.kernels.eig_chain import SWEEPS_F64
from sbdart_tpu_torch.ops.lane import _round_robin_pairs
from sbdart_tpu_torch.solver.deltam import apply_deltam
from sbdart_tpu_torch.solver.eig import angular_tables
from sbdart_tpu_torch.solver.fluxlane import beam_rows, general_operands

NAMES = ("kk", "gp", "gm", "zp", "zm")
NEAR_CONSERVATIVE = 3        # the column at ssalb 0.99999


def beam_operands(nstr, nlyr, b, seed=3, dtype=torch.float32):
    """(cppl, cpml, r1, r2, mu0, mu, w) as the flux path builds them."""
    rng = np.random.default_rng(seed)
    dtau = rng.uniform(0.001, 0.6, (b, nlyr))
    ssalb = rng.uniform(0.05, 0.999, (b, nlyr))
    ssalb[NEAR_CONSERVATIVE] = 0.99999
    g = rng.uniform(0.0, 0.85, (b, nlyr))
    pmom = g[..., None] ** np.arange(nstr + 1)
    fbeam = np.where(rng.uniform(size=b) < 0.8, 1.0, 0.0)
    umu0 = rng.uniform(0.2, 1.0, b)
    t = [torch.tensor(x, dtype=dtype) for x in (dtau, ssalb, pmom, fbeam,
                                                 umu0)]
    dm = apply_deltam(t[0], t[1], t[2], nstr, True)
    _, mu0, scale_row, _ = beam_rows(t[3], t[4])
    tab = angular_tables(nstr, 1)
    return general_operands(dm, tab, mu0, scale_row) + (tab.mu, tab.w)


def _sorted(kk, gp, gm):
    order = np.argsort(kk, axis=1)                     # [L, N, B]
    return (np.take_along_axis(kk, order, 1),
            np.take_along_axis(gp, order[:, None], 2),
            np.take_along_axis(gm, order[:, None], 2))


@pytest.fixture(scope="module",
                params=[(8, 3, 16), (16, 2, 16), (16, 2, 130), (12, 3, 16)],
                ids=["n4", "n8", "n8-b130", "n6"])
def both(request):
    nstr, nlyr, b = request.param
    ops = beam_operands(nstr, nlyr, b)
    ref = eig_beam_chain_lane_fused_layered(
        *(jnp.asarray(x.numpy()) for x in ops[:5]), ops[5], ops[6],
        interpret=True)
    got = eig_beam_chain_plain(*ops)
    ref = [np.asarray(r) for r in ref]
    got = [g.numpy() for g in got]
    for name, r, g in zip(NAMES, ref, got):
        assert g.shape == r.shape and g.dtype == np.float32, name
        assert np.isfinite(g).all(), name
    return ops, ref, got


def test_eig_beam_plain_matches_pallas_interpret(both):
    _, ref, got = both
    kk_r, gp_r, gm_r = _sorted(*ref[:3])
    kk_g, gp_g, gm_g = _sorted(*got[:3])
    assert np.abs(kk_r - kk_g).max() < 5e-5
    off = np.arange(kk_r.shape[-1]) != NEAR_CONSERVATIVE
    assert np.abs(gp_r - gp_g)[..., off].max() < 1e-3
    assert np.abs(gm_r - gm_g)[..., off].max() < 1e-3
    for name, r, g in zip(("zp", "zm"), ref[3:], got[3:]):
        assert np.abs(r - g).max() <= 1e-4 * np.abs(r).max(), name


def eigen_residuals(ops, kk, gp, gm):
    """Per-column max |(a-b) X + k Y| and |(a+b) Y + k X| over max |X|,
    with float64 operators."""
    cppl, cpml = (x.double().numpy() for x in ops[:2])
    mu, w = ops[5], ops[6]
    eye = np.eye(len(mu))[None, :, :, None]
    inv_mu = (1.0 / mu)[None, :, None, None]
    wj = w[None, None, :, None]
    amb = inv_mu * (eye - (cppl + cpml) * wj)
    apb = inv_mu * (eye - (cppl - cpml) * wj)
    kk, gp, gm = (np.asarray(x, np.float64) for x in (kk, gp, gm))
    x, y = gp + gm, gp - gm
    r1 = np.einsum("likb,lkjb->lijb", amb, x) + kk[:, None] * y
    r2 = np.einsum("likb,lkjb->lijb", apb, y) + kk[:, None] * x
    scale = max(np.abs(x).max(), 1.0)
    return (np.abs(r1).max(axis=(0, 1, 2)) / scale,
            np.abs(r2).max(axis=(0, 1, 2)) / scale)


def test_eig_beam_plain_satisfies_eigen_relations(both):
    ops, ref, got = both
    nc = NEAR_CONSERVATIVE
    for r_got, r_ref in zip(eigen_residuals(ops, *got[:3]),
                            eigen_residuals(ops, *ref[:3])):
        off = np.arange(len(r_got)) != nc
        assert r_got[off].max() < 5e-4, r_got[off].max()
        assert r_got[nc] <= 2.0 * r_ref[nc] + 5e-4, (r_got[nc], r_ref[nc])


def test_jacobi_schedule_is_the_reference_round_robin():
    from sbdart_tpu.ops.lane import _round_robin_pairs as ref_pairs

    for n in (4, 6, 8):
        assert _round_robin_pairs(n) == ref_pairs(n)


def test_eig_beam_f64_route_needs_more_sweeps():
    """Float64 at N = 8: the kernel's 3 sweeps leave eigen-relation
    residuals of ~3e-6 (float32 hides that), 4 reach the float64 floor, so
    the float64 route runs 6 (the reference lane route's).  Measured at 6:
    2.3e-14 off the near-conservative column, 3.6e-10 on it (its float64
    conditioning)."""
    ops = beam_operands(16, 2, 16, dtype=torch.float64)
    off = np.arange(16) != NEAR_CONSERVATIVE
    res3 = eigen_residuals(ops, *(x.numpy() for x in
                                  eig_beam_chain_plain(*ops, sweeps=3)[:3]))
    assert max(r[off].max() for r in res3) > 1e-7
    res6 = eigen_residuals(ops, *(x.numpy() for x in eig_beam_chain_plain(
        *ops, sweeps=SWEEPS_F64)[:3]))
    for res in res6:
        assert res[off].max() < 1e-12, res[off].max()
        assert res[NEAR_CONSERVATIVE] < 1e-8, res[NEAR_CONSERVATIVE]


def test_eig_beam_wrapper_takes_plain_version_on_cpu():
    before = launches(eig_beam_chain)
    ops = beam_operands(8, 2, 9, seed=4)
    for g, w in zip(eig_beam_chain(*ops), eig_beam_chain_plain(*ops)):
        assert torch.equal(g, w)
    assert launches(eig_beam_chain) == before
