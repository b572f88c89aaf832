"""The BRDF surface (solver/brdf.py): both models' Fourier reflection
matrices and hemispherical reflectance against the JAX package's, in
float64, at 1e-12 of each output's max, on the quadrature of nstr = 8 and
16, at beam cosines with batch axes (the per-column beam of the radiance
path), and with the models' parameters carried across by
convert.brdf_to_torch (numbers, numpy scalars and numpy arrays).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbdart_tpu.solver import brdf as ref_brdf
from sbdart_tpu.solver.eig import angular_tables as ref_angular_tables
from sbdart_tpu_torch.convert import brdf_to_torch
from sbdart_tpu_torch.solver import brdf

MODELS = [
    ref_brdf.HapkeBrdf(),
    ref_brdf.HapkeBrdf(b0=np.float64(0.8), hh=0.1, w=np.float64(0.9)),
    ref_brdf.RpvBrdf(),
    ref_brdf.RpvBrdf(rho0=0.25, k=np.float64(0.6), theta=0.2),
]


def _close(got, want, rel=1e-12):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.mark.parametrize("model", MODELS, ids=lambda m: repr(m))
@pytest.mark.parametrize("nstr", [8, 16])
def test_fourier_refl_matrices_match_reference(model, nstr):
    tab = ref_angular_tables(nstr, nstr)
    mu = np.asarray(tab.mu)
    port = brdf_to_torch(model, device="cpu", dtype=torch.float64)
    assert type(port).__name__ == type(model).__name__
    mu0 = np.array([[0.3], [0.75], [1.0]])             # [bc, 1] beam cosines
    for mu_out, mu_in in ((mu, mu), (mu, mu0), (np.array([0.2, 0.9]), mu)):
        want = ref_brdf.fourier_refl_matrices(
            model, jnp.asarray(mu_out), jnp.asarray(mu_in), nstr, jnp.float64)
        got = brdf.fourier_refl_matrices(
            port, torch.from_numpy(mu_out), torch.from_numpy(mu_in), nstr)
        _close(got, want)


@pytest.mark.parametrize("model", MODELS, ids=lambda m: repr(m))
def test_hemispherical_reflectance_matches_reference(model):
    tab = ref_angular_tables(8, 1)
    port = brdf_to_torch(model, device="cpu", dtype=torch.float64)
    mu_in = np.array([0.15, 0.5, 0.95])
    want = ref_brdf.hemispherical_reflectance(
        model, jnp.asarray(mu_in), tab.w, tab.mu, jnp.float64)
    got = brdf.hemispherical_reflectance(port, torch.from_numpy(mu_in),
                                         tab.w, tab.mu)
    _close(got, want)
    assert bool(((got > 0.0) & (got < 1.0)).all())


def test_brdf_to_torch_carries_parameters():
    arr = ref_brdf.HapkeBrdf(b0=np.array([1.0, 0.5]), hh=np.float64(0.06))
    port = brdf_to_torch(arr, device="cpu", dtype=torch.float64)
    assert isinstance(port, brdf.HapkeBrdf)
    assert torch.equal(port.b0, torch.tensor([1.0, 0.5], dtype=torch.float64))
    assert port.hh == 0.06 and isinstance(port.hh, float)
    assert port.w == 0.6
    with pytest.raises(TypeError, match="no port"):
        brdf_to_torch(object())


def test_lambertian_limit():
    """rho = alb / pi gives R_0 = 2 alb and R_{m>0} = 0."""
    class Lambert:
        def rho(self, mu_out, mu_in, cos_dphi):
            return 0.3 / np.pi + 0.0 * (mu_out * mu_in * cos_dphi)

    mu = torch.tensor([0.2, 0.7], dtype=torch.float64)
    r = brdf.fourier_refl_matrices(Lambert(), mu, mu, 3)
    assert torch.allclose(r[0], torch.full((2, 2), 0.6, dtype=torch.float64))
    assert float(r[1:].abs().max()) < 1e-15
