# Frozen copy of sbdart_tpu_torch/data/aerosols.py for the benchmark's reference: imports
# point into rtbench.reference.
# Later changes do not edit it.
"""Aerosol optical models.

Replaces the 5S/LOWTRAN aerosol tables of tauaero.f (reference component
#5).  Properties are MIE-COMPUTED from the published Shettle–Fenn model
microphysics (lognormal modes, component refractive indices, Hanel
hygroscopic growth) by data/aerosol_mie.py — see that module for the full
provenance — and tabulated on a (model x RH x wavelength) grid committed
as aerosol_mie.npz.

This module is the lookup layer: `bl_model` / `strat_model` interpolate
the tables (linear in RH, log-linear in wavelength) and return spectral
extinction relative to 0.55 um, single-scatter albedo, and asymmetry.
"""

from __future__ import annotations

import numpy as np

from rtbench.reference.data.aerosol_mie import BL_MODELS, STRAT_MODELS, tables

# default layer center altitudes [km] for the 5 stratospheric slots when
# zaer is not given (SBDART: jaer slots at ~20, 25, 30, 35, 40 km bands)
STRAT_DEFAULT_Z = [20.0, 25.0, 30.0, 35.0, 40.0]


def _grid():
    t = tables()
    return t["wl"], t["rh"], t


def __getattr__(name):
    # Lazy WL/RH_GRID: touching tables() at import time would silently run
    # a minutes-long Mie regeneration if the packaged npz were missing;
    # defer so the cost (and any error) surfaces at first USE instead.
    if name in ("WL", "RH_GRID"):
        wl, rh, _ = _grid()
        return wl if name == "WL" else rh
    raise AttributeError(name)


def _interp_wl(wl_grid: np.ndarray, y: np.ndarray, wl: np.ndarray):
    """Log-wavelength linear interpolation, clamped at the grid ends."""
    return np.interp(np.log(wl), np.log(wl_grid), y)


def bl_model(iaer: int, wl_um: np.ndarray, rh: float):
    """(ext_rel, w0, g) for boundary-layer model `iaer` at humidity rh [%].

    ext_rel is extinction relative to its 0.55 um value at the same rh.
    """
    if iaer not in BL_MODELS:
        raise ValueError(f"unknown BL aerosol model {iaer}")
    wl = np.asarray(wl_um, np.float64)
    wlg, rhg, t = _grid()
    i = sorted(BL_MODELS).index(iaer)
    rhc = float(np.clip(rh, rhg[0], rhg[-1]))
    jhi = int(np.searchsorted(rhg, rhc, side="left").clip(1, len(rhg) - 1))
    jlo = jhi - 1
    f = (rhc - rhg[jlo]) / (rhg[jhi] - rhg[jlo])
    out = []
    for name in ("bl_ext", "bl_w0", "bl_g"):
        y = (1.0 - f) * t[name][i, jlo] + f * t[name][i, jhi]
        out.append(_interp_wl(wlg, y, wl))
    ext, w0, g = out
    # renormalize so ext_rel(0.55) == 1 exactly after interpolation
    e55 = float(
        (1.0 - f) * np.interp(np.log(0.55), np.log(wlg), t["bl_ext"][i, jlo])
        + f * np.interp(np.log(0.55), np.log(wlg), t["bl_ext"][i, jhi])
    )
    return ext / e55, np.clip(w0, 0.0, 0.999999), np.clip(g, 0.0, 0.999)


def strat_model(jaer: int, wl_um: np.ndarray):
    """(ext_rel, w0, g) for stratospheric model jaer (1..4)."""
    if jaer not in STRAT_MODELS:
        raise ValueError(f"unknown stratospheric aerosol model {jaer}")
    wl = np.asarray(wl_um, np.float64)
    wlg, _, t = _grid()
    i = sorted(STRAT_MODELS).index(jaer)
    ext = _interp_wl(wlg, t["st_ext"][i], wl)
    w0 = _interp_wl(wlg, t["st_w0"][i], wl)
    g = _interp_wl(wlg, t["st_g"][i], wl)
    e55 = float(np.interp(np.log(0.55), np.log(wlg), t["st_ext"][i]))
    return ext / e55, np.clip(w0, 0.0, 0.999999), np.clip(g, 0.0, 0.999)
