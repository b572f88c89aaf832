"""BASELINE config 4's deck at nstr=32 in float32 through the generic
path's radiances (solver/radiance.py:compute_radiances): the port against
the JAX package's float32 route, each measured from the port's float64
route.

Config 4 (rural aerosol, vis 10 km, albedo 0.1, sza 40, 6 zenith x 3
azimuth views) at nstr=32, at the two wavelengths where float32 radiances
of this deck part most from float64 at nstr=16 (0.685 and 1.015 um): the
thin aerosol and gas layers (optical depth to ~6e-6) make the path
integrals' 1 - exp(-x) lose float32 digits, on both packages.  The
reference runs its float32 TPU route (the lane eigen chain at N = 16, its
block-Thomas kernels in the Pallas interpreter), one jit for both
wavelengths.  Bar: the port's uu lies within twice the reference's
distance from the float64 route (of uu's max), at each wavelength
(measured 4.2e-5 against 4.8e-5 at 0.685 um, 7.7e-5 against 5.3e-5 at
1.015 um).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sbdart_tpu_torch.atmosphere import build_profile
from sbdart_tpu_torch.clouds import apply_cloud_humidity
from sbdart_tpu_torch.config import Config
from sbdart_tpu_torch.optics import build_optical_deck
from sbdart_tpu_torch.pipeline import user_angles
from sbdart_tpu_torch.solar import solar_geometry, solar_irradiance
from sbdart_tpu_torch.solver.disort import solve_rte
from sbdart_tpu_torch.surface import surface_albedo
from test_torch_generic import ref_solve

WAVELENGTHS = np.array([0.685, 1.015])


@pytest.fixture(scope="module")
def config4_nstr32():
    """Config 4's solve inputs at WAVELENGTHS and nstr=32: (dtau, ssalb,
    pmom) [wl, k, ...] and the keywords of solve_rte."""
    cfg = Config(idatm=2, iaer=1, vis=10, albcon=0.1, nstr=32, sza=40,
                 wlinf=0.25, wlsup=2.0, wlinc=0.005, nzen=6,
                 uzen=[0, 30, 60, 75, 120, 150], nphi=3, phi=[0, 90, 180],
                 iout=20).validate()
    umu, phi = user_angles(cfg)
    profile = apply_cloud_humidity(build_profile(cfg), cfg)
    deck = build_optical_deck(profile, cfg, WAVELENGTHS, 65, None, None)
    csza, solfac = solar_geometry(cfg)
    fbeam = solar_irradiance(WAVELENGTHS, cfg.nf) * solfac
    args = (deck.dtau, deck.ssalb, deck.pmom[:, None])
    kw = dict(nstr=32, fbeam=(fbeam * (csza > 0))[:, None],
              umu0=float(csza),
              albedo=surface_albedo(cfg, WAVELENGTHS, None)[:, None],
              onlyfl=False, umu=np.round(umu, 10), phi=np.round(phi, 10))
    return args, kw


def _port(args, kw, dtype):
    t = {k: torch.as_tensor(v, dtype=dtype) if isinstance(v, np.ndarray)
         and k not in ("umu", "phi") else v for k, v in kw.items()}
    return solve_rte(*(torch.as_tensor(x, dtype=dtype) for x in args),
                     dtype=dtype, device="cpu", **t).uu.numpy()


def test_config4_nstr32_f32_radiances_no_further_from_f64_than_reference(
        config4_nstr32):
    args, kw = config4_nstr32
    f64 = _port(args, kw, torch.float64)
    got = _port(args, kw, torch.float32)
    ref = np.asarray(ref_solve(args, kw, jnp.float32, "lane",
                               "kernel_interpret").uu)
    assert got.shape == ref.shape == f64.shape
    assert np.isfinite(got).all()
    for w in range(len(WAVELENGTHS)):
        scale = np.abs(f64[w]).max()
        port_err = np.abs(got[w] - f64[w]).max() / scale
        ref_err = np.abs(ref[w] - f64[w]).max() / scale
        assert port_err <= 2.0 * ref_err, (WAVELENGTHS[w], port_err, ref_err)
