# Frozen copy of sbdart_tpu_torch/aerosols.py for the benchmark's reference: imports
# point into rtbench.reference.
# Later changes do not edit it.
"""Aerosol optical properties.

Replaces tauaero.f (reference component #5): boundary-layer aerosol models
scaled by visibility or optical depth, stratospheric aerosol slots, and
user-defined spectral aerosols — producing per-(wavelength, layer) optical
depth, single-scatter albedo and asymmetry (HG phase via imoma=3 default).

Reference namelist semantics implemented:
  iaer: 0 none; 1 rural, 2 urban, 3 oceanic, 4 tropospheric;
        5 user spectral (wlbaer/qbaer/wbaer/gbaer); -1 aerosol.dat file.
  vis:  surface meteorological visibility [km] -> BL extinction
        beta(0.55) = 3.912/vis - 0.01159 km^-1 (Koschmieder minus Rayleigh).
  tbaer: BL optical depth at 0.55 um (overrides vis when > 0).
  rhaer: relative humidity for the model (< 0: use profile RH per layer).
  zbaer/dbaer: user vertical profile (altitude, relative density).
  jaer/zaer/taerst: up to 5 stratospheric layers.
  abaer: Angstrom exponent for the user spectral model.
"""

from __future__ import annotations

import numpy as np

from rtbench.reference.atmosphere import Profile, relative_humidity
from rtbench.reference.config import Config
from rtbench.reference.data.aerosols import STRAT_DEFAULT_Z, bl_model, strat_model

BL_SCALE_HEIGHT_KM = 1.05   # 5S-class exponential mixing height


def _bl_profile_weights(profile: Profile, cfg: Config) -> np.ndarray:
    """Normalized per-layer weights of the BL aerosol burden."""
    z_top = profile.z[:-1]
    z_bot = profile.z[1:]
    zm = 0.5 * (z_top + z_bot)
    dz = z_top - z_bot
    if cfg.zbaer[0] >= 0.0:
        zs = np.array([z for z in cfg.zbaer if z >= 0.0])
        ds = np.array([d for d in cfg.dbaer[: len(zs)]])
        dens = np.interp(zm, np.sort(zs), ds[np.argsort(zs)], left=0.0, right=0.0)
    else:
        dens = np.exp(-np.maximum(zm - profile.z[-1], 0.0) / BL_SCALE_HEIGHT_KM)
        dens[zm > 12.0] = 0.0
    w = dens * dz
    s = w.sum()
    return w / s if s > 0 else w


def _bl_tau55(cfg: Config) -> float:
    if cfg.tbaer >= 0.0:
        return float(cfg.tbaer)
    beta = 3.912 / max(cfg.vis, 1e-3) - 0.01159
    return max(beta, 0.0) * BL_SCALE_HEIGHT_KM


def _user_spectral(cfg: Config, wl: np.ndarray, user_table=None):
    """User spectral aerosol: ext_rel(wl), w0(wl), g(wl)."""
    if user_table is not None:
        uwl, uq, uw0, ug = user_table
        ext = np.interp(wl, uwl, uq)
        w0 = np.interp(wl, uwl, uw0)
        g = np.interp(wl, uwl, ug)
        return ext, w0, g
    wlb = np.array([w for w in cfg.wlbaer if w > 0.0])
    if wlb.size:
        qb = np.array(cfg.qbaer[: wlb.size])
        ext = np.interp(wl, wlb, qb / np.interp(0.55, wlb, qb))
    elif cfg.abaer >= 0.0 or cfg.abaer < 0:
        alpha = cfg.abaer if cfg.abaer > -90 else 1.0
        ext = (wl / 0.55) ** (-alpha)
    w0 = np.full_like(wl, cfg.wbaer[0])
    g = np.full_like(wl, cfg.gbaer[0])
    return ext, w0, g


def load_aerosol_dat(path: str):
    """aerosol.dat: rows of (wl, q_ext_rel, w0, g)."""
    d = np.atleast_2d(np.loadtxt(path))
    return d[:, 0], d[:, 1], d[:, 2], d[:, 3]


def aerosol_optical_properties(
    profile: Profile,
    cfg: Config,
    wl_um: np.ndarray,
    user_table=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(tau, w0, g) each [nwl, nlyr] for all aerosol components combined."""
    wl = np.atleast_1d(np.asarray(wl_um, np.float64))
    nwl, nlyr = wl.shape[0], profile.nlyr
    tau = np.zeros((nwl, nlyr))
    scat = np.zeros((nwl, nlyr))
    gscat = np.zeros((nwl, nlyr))

    def add(t, w0, g):
        tau[...] += t
        scat[...] += t * w0
        gscat[...] += t * w0 * g

    # ---- boundary layer ---------------------------------------------------
    if cfg.iaer != 0:
        wlyr = _bl_profile_weights(profile, cfg)         # [nlyr]
        t55 = _bl_tau55(cfg)
        if cfg.iaer in (1, 2, 3, 4):
            if cfg.rhaer >= 0.0:
                ext, w0s, gs = bl_model(cfg.iaer, wl, cfg.rhaer)
                add(t55 * ext[:, None] * wlyr[None, :], w0s[:, None], gs[:, None])
            else:
                # per-layer humidity from the profile
                rh_lev = relative_humidity(profile)
                rh_lay = 0.5 * (rh_lev[:-1] + rh_lev[1:])
                # growth changes the column normalization; normalize at 70%
                t_l = np.zeros((nwl, nlyr))
                w_l = np.zeros((nwl, nlyr))
                g_l = np.zeros((nwl, nlyr))
                for li in range(nlyr):
                    ext, w0s, gs = bl_model(cfg.iaer, wl, float(rh_lay[li]))
                    t_l[:, li] = ext * wlyr[li]
                    w_l[:, li] = w0s
                    g_l[:, li] = gs
                # renormalize so tau(0.55) column = t55
                ext55 = np.zeros(nlyr)
                for li in range(nlyr):
                    e55, _, _ = bl_model(cfg.iaer, np.array([0.55]), float(rh_lay[li]))
                    ext55[li] = e55[0] * wlyr[li]
                norm = t55 / max(ext55.sum(), 1e-30)
                add(t_l * norm, w_l, g_l)
        elif cfg.iaer == 5 or cfg.iaer == -1:
            if cfg.iaer == -1 and user_table is None:
                user_table = load_aerosol_dat("aerosol.dat")
            ext, w0s, gs = _user_spectral(cfg, wl, user_table)
            add(t55 * ext[:, None] * wlyr[None, :], w0s[:, None], gs[:, None])
        else:
            raise ValueError(f"unsupported iaer={cfg.iaer}")

    # ---- stratospheric slots ----------------------------------------------
    z_top = profile.z[:-1]
    z_bot = profile.z[1:]
    for s in range(5):
        ta = cfg.taerst[s]
        ja = cfg.jaer[s]
        if ta <= 0.0 or ja <= 0:
            continue
        zc = cfg.zaer[s] if cfg.zaer[s] > 0 else STRAT_DEFAULT_Z[s]
        # gaussian layer of ~3 km half-width
        zm = 0.5 * (z_top + z_bot)
        dz = z_top - z_bot
        wgt = np.exp(-0.5 * ((zm - zc) / 3.0) ** 2) * dz
        ssum = wgt.sum()
        if ssum <= 0:
            continue
        wgt /= ssum
        ext, w0s, gs = strat_model(ja, wl)
        add(ta * ext[:, None] * wgt[None, :], w0s[:, None], gs[:, None])

    w0 = np.where(tau > 0, scat / np.maximum(tau, 1e-300), 0.0)
    g = np.where(scat > 0, gscat / np.maximum(scat, 1e-300), 0.0)
    return tau, w0, g
