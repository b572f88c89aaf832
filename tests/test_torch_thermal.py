"""The thermal particular solution and its pieces against the JAX package's:
lsolve (branchless partial-pivoted GE), _ylm_at (Legendre at traced
cosines) and thermal_particular, all in float64 on the same NumPy inputs;
and the flux lane's scan-layout version
(kernels/thermal.py:thermal_particular_scan_plain, the plain twin of its
CUDA kernel: C^pp/C^pm as explicit sums over l) against the reference's
scattering_matrices and thermal_particular, moved to scan layout.

The scattering matrices are random but physical in scale: C^pp/C^pm from
HG moments at single-scatter albedos up to a near-conservative layer
(1 - 1e-6); the optical depths include a layer below the float64 slope
floor (1e-8) so the floor path is taken.  Same algorithm, same pivot
rule: agreement to 1e-12 of each output's largest magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbdart_tpu.ops.lane import lsolve as ref_lsolve
from sbdart_tpu.solver.eig import angular_tables as ref_angular_tables
from sbdart_tpu.solver.eig import scattering_matrices
from sbdart_tpu.solver.sources import _ylm_at as ref_ylm_at
from sbdart_tpu.solver.sources import thermal_particular as ref_thermal
from sbdart_tpu_torch.kernels.thermal import thermal_particular_scan_plain
from sbdart_tpu_torch.ops.lane import lsolve
from sbdart_tpu_torch.solver.eig import angular_tables
from sbdart_tpu_torch.solver.sources import _ylm_at, thermal_particular

BAR = 1e-12


def _close(got, ref, bar=BAR):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= bar * np.abs(ref).max(), \
        np.abs(got - ref).max() / np.abs(ref).max()


def test_lsolve_matches_reference_with_pivoting():
    """Random systems, some with a zero leading entry so that every step
    of partial pivoting exchanges rows."""
    rng = np.random.default_rng(0)
    n, m, b = 6, 3, 50
    a = rng.normal(size=(n, n, b))
    a[0, 0, ::3] = 0.0
    a[1, 1, ::5] = 1e-9
    rhs = rng.normal(size=(n, m, b))
    ref = ref_lsolve(jnp.asarray(a), jnp.asarray(rhs))
    got = lsolve(torch.from_numpy(a), torch.from_numpy(rhs))
    _close(got, ref)
    # it solves the system
    res = np.einsum("ijb,jkb->ikb", a, got.numpy()) - rhs
    assert np.abs(res).max() < 1e-10


def test_ylm_at_matches_reference():
    rng = np.random.default_rng(1)
    mu0 = rng.uniform(0.05, 1.0, (4, 7))
    for nmode, nmom in ((1, 4), (1, 16), (3, 9)):
        ref = ref_ylm_at(jnp.asarray(mu0), nmode, nmom, jnp.float64)
        _close(_ylm_at(torch.from_numpy(mu0), nmode, nmom), ref)


def thermal_problem(nstr, nbc=5, nlyr=6, seed=2):
    rng = np.random.default_rng(seed)
    ssalb = rng.uniform(0.05, 0.95, (nbc, nlyr))
    ssalb[1, 2] = 1.0 - 1e-6                      # near-conservative layer
    dtau = 10.0 ** rng.uniform(-4.0, 0.3, (nbc, nlyr))
    dtau[0, 1] = 3e-9                             # below the f64 slope floor
    g = rng.uniform(0.0, 0.85, (nbc, nlyr))
    gl = g[..., None] ** np.arange(nstr)
    temper = np.linspace(210.0, 295.0, nlyr + 1) + rng.uniform(
        -5.0, 5.0, (nbc, nlyr + 1))
    # Planck radiance at the levels: any smooth positive profile will do
    b_level = 5.670374419e-8 / np.pi * temper**4 * 0.03
    return ssalb, dtau, gl, b_level


def test_thermal_particular_matches_reference():
    for nstr in (4, 8, 16):
        tab = ref_angular_tables(nstr, 1)
        ssalb, dtau, gl, b_level = thermal_problem(nstr)
        cpp, cpm = scattering_matrices(jnp.asarray(ssalb), jnp.asarray(gl),
                                       tab, jnp.float64)
        cpp0, cpm0 = cpp[..., 0, :, :, :], cpm[..., 0, :, :, :]
        ref = ref_thermal(cpp0, cpm0, jnp.asarray(ssalb), jnp.asarray(dtau),
                          jnp.asarray(b_level), tab, jnp.float64)
        got = thermal_particular(
            torch.from_numpy(np.array(cpp0)),
            torch.from_numpy(np.array(cpm0)), torch.from_numpy(ssalb),
            torch.from_numpy(dtau), torch.from_numpy(b_level),
            angular_tables(nstr, 1))
        for name, g_, r_ in zip(ref._fields, got, ref):
            assert g_.dtype == torch.float64, name
            _close(g_, r_)


@pytest.mark.parametrize("nstr", [4, 8, 12, 16])
def test_scan_plain_version_matches_reference(nstr):
    """The explicit-sum twin, in float64, against the reference's einsums
    and thermal_particular; [..., L, N] moved to [L, N, B]."""
    tab = ref_angular_tables(nstr, 1)
    ssalb, dtau, gl, b_level = thermal_problem(nstr, seed=nstr)
    cpp, cpm = scattering_matrices(jnp.asarray(ssalb), jnp.asarray(gl),
                                   tab, jnp.float64)
    ref = ref_thermal(cpp[..., 0, :, :, :], cpm[..., 0, :, :, :],
                      jnp.asarray(ssalb), jnp.asarray(dtau),
                      jnp.asarray(b_level), tab, jnp.float64)
    got = thermal_particular_scan_plain(
        *(torch.from_numpy(a) for a in (ssalb, dtau, gl, b_level)),
        angular_tables(nstr, 1))
    assert got[3] is got[2]
    for g_, r_ in zip(got, ref[:4]):
        r_ = np.moveaxis(np.asarray(r_), -2, 0)            # [L, nbc, N]
        assert g_.dtype == torch.float64
        _close(g_, np.moveaxis(r_, -1, 1))
