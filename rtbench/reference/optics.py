# Frozen copy of sbdart_tpu_torch/optics.py for the benchmark's reference: imports
# point into rtbench.reference.
# Later changes do not edit it.
"""Combine per-process optical properties into solver inputs.

The L3 -> L2 contract of the reference (SURVEY.md section 2): per
(wavelength, k-term, layer) total optical depth DTAUC, single-scatter albedo
SSALB and phase moments PMOM assembled from Rayleigh + gas + cloud +
aerosol, exactly as sbdart.f does before each DISORT call — but as whole
spectral tensors, not one wavelength at a time.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from rtbench.reference.aerosols import aerosol_optical_properties
from rtbench.reference.atmosphere import Profile
from rtbench.reference.clouds import cloud_optical_properties
from rtbench.reference.config import Config
from rtbench.reference.gas import gas_optical_depth
from rtbench.reference.rayleigh import rayleigh_layer_tau, rayleigh_moments


class OpticalDeck(NamedTuple):
    """Solver-ready optical properties for the whole spectral grid."""
    wl: np.ndarray      # [nwl] um
    dtau: np.ndarray    # [nwl, nk, nlyr]
    ssalb: np.ndarray   # [nwl, nk, nlyr]
    pmom: np.ndarray    # [nwl, nlyr, nmom]  (k-independent: gas is pure abs)
    wk: np.ndarray      # [nwl, nk] k-distribution weights
    tau_ray: np.ndarray  # [nwl, nlyr] (diagnostics)
    tau_gas: np.ndarray  # [nwl, nk, nlyr]
    tau_cld: np.ndarray  # [nwl, nlyr]
    tau_aer: np.ndarray  # [nwl, nlyr]


def component_moments(
    g: np.ndarray,           # [nwl, nlyr] asymmetry parameter
    imom: int,
    nmom: int,
    user_moments: np.ndarray | None = None,   # [nmom_user] (l = 1..)
) -> np.ndarray:
    """Phase-function moments for one scattering component — the
    disort.f:GETMOM equivalent driven by the namelist imomc/imoma selectors.

      imom = 1: isotropic
      imom = 2: Rayleigh
      imom = 3: Henyey-Greenstein from g (the reference default)
      imom = 4: true Mie moments (clouds only — handled by the caller via
                clouds.cloud_mie_moments; reaching here with 4 means the
                component has no Mie table and raises)

    `user_moments` (the pmaer namelist array, moments for l >= 1 with
    g_0 = 1 implied) overrides the selector when present.  Other imom
    values raise: the reference's haze-L / cloud-C1 GETMOM entries are
    disotest-battery fixtures, not physics the program exposes.
    """
    nwl, nlyr = g.shape
    if user_moments is not None and len(user_moments) > 0:
        m = np.zeros((nwl, nlyr, nmom))
        m[..., 0] = 1.0
        um = np.asarray(user_moments, np.float64)[: nmom - 1]
        m[..., 1: 1 + len(um)] = um
        return m
    if imom == 1:
        m = np.zeros((nwl, nlyr, nmom))
        m[..., 0] = 1.0
        return m
    if imom == 2:
        m = np.zeros((nwl, nlyr, nmom))
        m[..., 0] = 1.0
        if nmom > 2:
            m[..., 2] = 0.1
        return m
    if imom == 3:
        return g[..., None] ** np.arange(nmom)
    raise NotImplementedError(
        f"imomc/imoma={imom} is not implemented (supported: 1 isotropic, "
        "2 Rayleigh, 3 Henyey-Greenstein; or user moments via pmaer)"
    )


def build_optical_deck(
    profile: Profile,
    cfg: Config,
    wl: np.ndarray,
    nmom: int,
    usrcld: np.ndarray | None = None,
    aer_table=None,
) -> OpticalDeck:
    wl = np.atleast_1d(np.asarray(wl, np.float64))
    nwl, nlyr = wl.shape[0], profile.nlyr

    # Rayleigh (pbar == 0 disables it — reference convention)
    if cfg.pbar == 0.0:
        tau_r = np.zeros((nwl, nlyr))
    else:
        tau_r = rayleigh_layer_tau(wl, profile.p, cfg.xrsc)

    tau_g, wk = gas_optical_depth(profile, cfg, wl)       # [nwl, nk, nlyr]
    tau_c, w0_c, g_c = cloud_optical_properties(profile, cfg, wl, usrcld)
    tau_a, w0_a, g_a = aerosol_optical_properties(profile, cfg, wl, aer_table)

    nk = tau_g.shape[1]
    dtau = tau_r[:, None, :] + tau_g + (tau_c + tau_a)[:, None, :]
    scat_r = tau_r
    scat_c = w0_c * tau_c
    scat_a = w0_a * tau_a
    scat = scat_r + scat_c + scat_a                        # [nwl, nlyr]
    ssalb = scat[:, None, :] / np.maximum(dtau, 1e-30)
    ssalb = np.clip(ssalb, 0.0, 1.0)

    # phase moments: Rayleigh exact; cloud/aerosol per imomc/imoma (+ pmaer)
    mom_r = rayleigh_moments(nmom)                         # [nmom]
    if cfg.imomc == 4:
        from rtbench.reference.clouds import cloud_mie_moments

        mom_c = cloud_mie_moments(profile, cfg, wl, nmom, usrcld)
    else:
        mom_c = component_moments(g_c, cfg.imomc, nmom)    # [nwl, nlyr, nmom]
    pmaer = np.asarray([p for p in cfg.pmaer], np.float64)
    mom_a = component_moments(
        g_a, cfg.imoma, nmom,
        user_moments=pmaer if pmaer.size else None,
    )
    num = (
        scat_r[..., None] * mom_r
        + scat_c[..., None] * mom_c
        + scat_a[..., None] * mom_a
    )
    pmom = num / np.maximum(scat[..., None], 1e-30)
    pmom[..., 0] = 1.0

    if cfg.spowder:
        # Sub-surface snow-powder slab (sbdart.f namelist `spowder`,
        # SURVEY.md A1): one optically semi-infinite scattering layer of
        # coarse ice grains appended BELOW the surface level, with the
        # configured Lambertian surface beneath it.  PROVISIONAL semantics
        # (reference mount empty): grain radius 100 um (aged snow), slab
        # optical depth 2000 — deep enough that the underlying surface is
        # invisible at every wavelength; Mie ice optics from data/mie.py
        # give the spectrally correct visible-bright / NIR-dark behavior
        # (tests/test_namelist_semantics.py::TestSpowder).
        w0_p, g_p = snow_powder_properties(wl)
        tau_p = np.full((nwl, nk, 1), 2000.0)
        dtau = np.concatenate([dtau, tau_p], axis=2)
        ssalb = np.concatenate(
            [ssalb, np.broadcast_to(
                np.clip(w0_p, 0.0, 1.0)[:, None, None], (nwl, nk, 1)
            )], axis=2,
        )
        mom_p = g_p[:, None] ** np.arange(nmom)
        pmom = np.concatenate([pmom, mom_p[:, None, :]], axis=1)
        zed = np.zeros((nwl, 1))
        tau_r = np.concatenate([tau_r, zed], axis=1)
        tau_c = np.concatenate([tau_c, zed], axis=1)
        tau_a = np.concatenate([tau_a, zed], axis=1)
        tau_g = np.concatenate(
            [tau_g, np.zeros((nwl, nk, 1))], axis=2
        )

    return OpticalDeck(wl, dtau, ssalb, pmom, wk, tau_r, tau_g, tau_c, tau_a)


def snow_powder_properties(wl: np.ndarray, re: float = 100.0):
    """(w0, g) of a coarse-grained ice powder at each wavelength.

    Interpolated from the packaged ice Mie tables (data/mie.py, Warren-1984
    -class refractive indices) at the slab's grain radius.
    """
    from rtbench.reference.data.mie import tables as mie_tables

    t = mie_tables()
    reg = np.asarray(t["re"], np.float64)
    wlg = np.asarray(t["wl"], np.float64)
    i = int(np.clip(np.searchsorted(reg, re) - 1, 0, len(reg) - 2))
    fr = (np.log(re) - np.log(reg[i])) / (np.log(reg[i + 1]) - np.log(reg[i]))
    fr = float(np.clip(fr, 0.0, 1.0))

    def interp_row(tab):
        row = (1.0 - fr) * tab[i] + fr * tab[i + 1]
        return np.interp(wl, wlg, row)

    return interp_row(t["ice_w0"]), interp_row(t["ice_g"])
