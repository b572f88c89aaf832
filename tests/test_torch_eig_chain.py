"""B9 (the eigen chain without the beam solve): the port's plain torch
version against the JAX package's Pallas kernel run through the
interpreter (eig_chain_lane_fused, interpret=True), at the (nstr, nlyr, b)
cases of tests/test_pallas_kernels.py:237 (N = 2, 4, 8) and at N = 6, on
the same float32 operands: the generic path's all-mode C^pp/C^pm of random
optics (ssalb U(0.05, 0.999), HG moments of g U(0, 0.85)) in lane layout.

Bars, the reference's own (tests/test_pallas_kernels.py:189-263):
eigenpairs sorted by kk on both sides (neither route sorts), kk within
5e-5 and G+- within 1e-3; the eigen relations (alpha-beta) X = -k Y and
(alpha+beta) Y = -k X (X = G+ + G-, Y = G+ - G-) against float64
operators, residual below 5e-4 of max |X| at the reference's residual
case (nstr 8, 5 layers, 16 columns).  At the line-237 cases the
reference's own kernel leaves (alpha+beta) residuals up to 2.9e-3
(near-conservative layers, nstr 16); there the port is held to twice the
reference's residual.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from launch_counts import launches

from sbdart_tpu.pallas.eig import eig_chain_lane_fused
from sbdart_tpu_torch.kernels.eig_chain import (
    SWEEPS_F64,
    chain_entry,
    eig_chain,
    eig_chain_lane,
    eig_chain_plain,
)
from sbdart_tpu_torch.ops import lane
from sbdart_tpu_torch.solver.eig import angular_tables, scattering_matrices


def chain_operands(nstr, nlyr, b, seed=3, dtype=torch.float32, nmode=1):
    """(cppl, cpml [N, N, lanes], mu, w) from tests/test_pallas_kernels.py:
    _eig_problem's optics (nmode azimuth modes), flattened to lanes as
    solver/eig.py:solve_eigen does."""
    rng = np.random.default_rng(seed)
    ssalb = torch.tensor(rng.uniform(0.05, 0.999, (b, 1, nlyr)), dtype=dtype)
    g = rng.uniform(0.0, 0.85, (b, 1, nlyr))
    gl = torch.tensor(g[..., None] ** np.arange(nstr), dtype=dtype)
    tab = angular_tables(nstr, nmode)
    cpp, cpm = scattering_matrices(ssalb, gl, tab)
    return lane.to_lane(cpp)[0], lane.to_lane(cpm)[0], tab.mu, tab.w


def _sorted(kk, gp, gm):
    order = np.argsort(kk, axis=0)                     # [N, lanes]
    return (np.take_along_axis(kk, order, 0),
            np.take_along_axis(gp, order[None], 1),
            np.take_along_axis(gm, order[None], 1))


def eigen_residuals(cppl, cpml, mu, w, kk, gp, gm):
    """max |(a-b) X + k Y| and |(a+b) Y + k X| over max |X|, float64."""
    cppl, cpml = (np.asarray(x, np.float64) for x in (cppl, cpml))
    n = len(mu)
    eye = np.eye(n)[:, :, None]
    amb = (1.0 / mu)[:, None, None] * (eye - (cppl + cpml) * w[None, :, None])
    apb = (1.0 / mu)[:, None, None] * (eye - (cppl - cpml) * w[None, :, None])
    kk, gp, gm = (np.asarray(x, np.float64) for x in (kk, gp, gm))
    x, y = gp + gm, gp - gm
    r1 = np.einsum("ikb,kjb->ijb", amb, x) + kk[None] * y
    r2 = np.einsum("ikb,kjb->ijb", apb, y) + kk[None] * x
    scale = max(np.abs(x).max(), 1.0)
    return np.abs(r1).max() / scale, np.abs(r2).max() / scale


@pytest.mark.parametrize("all_modes", [False, True], ids=["mode0", "all"])
@pytest.mark.parametrize("nstr,nlyr,b", [(4, 5, 7), (8, 3, 130), (16, 9, 13),
                                         (12, 4, 11)])
def test_eig_chain_plain_matches_pallas_interpret(nstr, nlyr, b, all_modes):
    """Mode 0 (the reference test's operands) and all nstr modes (the
    generic path's all-mode lanes)."""
    cppl, cpml, mu, w = chain_operands(nstr, nlyr, b,
                                       nmode=nstr if all_modes else 1)
    ref = eig_chain_lane_fused(jnp.asarray(cppl.numpy()),
                               jnp.asarray(cpml.numpy()), mu, w,
                               interpret=True)
    got = eig_chain_lane(cppl, cpml, mu, w)
    ref = [np.asarray(r) for r in ref]
    got = [g.numpy() for g in got]
    for r, g in zip(ref, got):
        assert g.shape == r.shape and g.dtype == np.float32
        assert np.isfinite(g).all()
    kk_r, gp_r, gm_r = _sorted(*ref)
    kk_g, gp_g, gm_g = _sorted(*got)
    assert np.abs(kk_r - kk_g).max() < 5e-5
    assert np.abs(gp_r - gp_g).max() < 1e-3
    assert np.abs(gm_r - gm_g).max() < 1e-3
    for res, res_ref in zip(eigen_residuals(cppl, cpml, mu, w, *got),
                            eigen_residuals(cppl, cpml, mu, w, *ref)):
        assert res <= max(5e-4, 2.0 * res_ref), (res, res_ref)


def test_eig_chain_plain_satisfies_eigen_relations():
    """tests/test_pallas_kernels.py:189-221's case and bar."""
    cppl, cpml, mu, w = chain_operands(8, 5, 16)
    got = eig_chain_lane(cppl, cpml, mu, w)
    for res in eigen_residuals(cppl, cpml, mu, w, *got):
        assert res < 5e-4, res


def test_eig_chain_n2_is_the_half_angle_chain():
    """At N = 2 the chain's eigensolve is B1/B3/B8's half-angle eigh
    (kernels/eig_n2.py:eigh2_half_angle), not Jacobi: the sweep count
    changes nothing."""
    cppl, cpml, mu, w = chain_operands(4, 3, 11)
    ops = (cppl[None], cpml[None], mu, w)
    for a, b in zip(eig_chain_plain(*ops, sweeps=0),
                    eig_chain_plain(*ops, sweeps=5)):
        assert torch.equal(a, b)


def test_eig_chain_f64_with_six_sweeps_is_exact():
    """In float64 with the f64 route's 6 sweeps the chain's eigenpairs
    satisfy the eigen relations to rounding (N = 8)."""
    cppl, cpml, mu, w = chain_operands(16, 2, 5, dtype=torch.float64,
                                       nmode=16)
    got = eig_chain_plain(cppl[None], cpml[None], mu, w, sweeps=SWEEPS_F64)
    res = eigen_residuals(cppl, cpml, mu, w, *(x[0] for x in got))
    assert max(res) < 1e-10, res


def test_eig_chain_wrapper_takes_plain_version_on_cpu():
    cppl, cpml, mu, w = chain_operands(8, 2, 9)
    before = launches(eig_chain)
    for g, p in zip(eig_chain(cppl[None], cpml[None], mu, w),
                    eig_chain_plain(cppl[None], cpml[None], mu, w)):
        assert torch.equal(g, p)
    assert launches(eig_chain) == before


def test_eig_chain_entry_by_n():
    """The wrapper's choice of kernel by N: the one-thread half-angle
    chain at N = 2, the lane-group chain at N = 4, 6, 8, and a ValueError
    at any other N (no fallback to the plain version)."""
    assert chain_entry(2) == "sbdart_eig_chain"
    for n in (4, 6, 8):
        assert chain_entry(n) == "sbdart_eig_chain_group"
    for n in (1, 3, 5, 9, 16):
        with pytest.raises(ValueError, match="N = 2, 4, 6 or 8"):
            chain_entry(n)
