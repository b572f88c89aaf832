# Frozen copy of sbdart_tpu_torch/solar.py for the benchmark's reference: imports
# point into rtbench.reference.
# Later changes do not edit it.
"""Solar geometry and spectral weighting.

Replaces ZENSUN (reference component #8; Ricchiazzi's well-known ephemeris
routine) with the standard Spencer (1971) Fourier-series ephemeris —
declination, equation of time, and Earth–Sun distance factor — plus the
spectral machinery of spectra.f (solar irradiance selection and satellite
filter functions).
"""

from __future__ import annotations

import numpy as np

from rtbench.reference.config import Config
from rtbench.reference.data.solar import solar_irradiance


def zensun(iday: int, time_ut: float, alat: float, alon: float):
    """Solar zenith/azimuth [deg] and Earth–Sun distance factor.

    Args:
      iday: day of year (1..365).
      time_ut: UTC decimal hours.
      alat, alon: latitude/longitude [deg], east positive.

    Returns:
      (zenith_deg, azimuth_deg, solfac) with solfac = (r0/r)^2.
    """
    g = 2.0 * np.pi * (iday - 1 + (time_ut - 12.0) / 24.0) / 365.0
    # Spencer (1971): declination [rad]
    decl = (
        0.006918
        - 0.399912 * np.cos(g) + 0.070257 * np.sin(g)
        - 0.006758 * np.cos(2 * g) + 0.000907 * np.sin(2 * g)
        - 0.002697 * np.cos(3 * g) + 0.00148 * np.sin(3 * g)
    )
    # equation of time [minutes]
    eqt = 229.18 * (
        0.000075
        + 0.001868 * np.cos(g) - 0.032077 * np.sin(g)
        - 0.014615 * np.cos(2 * g) - 0.040849 * np.sin(2 * g)
    )
    # Earth-Sun distance factor (1/r^2 in AU)
    solfac = (
        1.000110
        + 0.034221 * np.cos(g) + 0.001280 * np.sin(g)
        + 0.000719 * np.cos(2 * g) + 0.000077 * np.sin(2 * g)
    )
    # hour angle [deg]: solar time = UTC + lon/15 + eqt/60
    tsolar = time_ut + alon / 15.0 + eqt / 60.0
    ha = np.deg2rad(15.0 * (tsolar - 12.0))
    lat = np.deg2rad(alat)
    cosz = np.sin(lat) * np.sin(decl) + np.cos(lat) * np.cos(decl) * np.cos(ha)
    zen = np.rad2deg(np.arccos(np.clip(cosz, -1.0, 1.0)))
    sinz = np.sqrt(max(1.0 - cosz**2, 1e-12))
    cosa = (np.sin(decl) - np.sin(lat) * cosz) / (np.cos(lat) * sinz)
    azi = np.rad2deg(np.arccos(np.clip(cosa, -1.0, 1.0)))
    if np.sin(ha) > 0:
        azi = 360.0 - azi
    return float(zen), float(azi), float(solfac)


def solar_geometry(cfg: Config) -> tuple[float, float]:
    """Resolve (cos_sza, solfac) from the namelist parameters.

    Priority (sbdart.f): csza >= 0 wins; else iday > 0 invokes the ephemeris;
    else sza is used directly.  solfac multiplies the beam irradiance.
    """
    solfac = cfg.solfac
    if cfg.csza >= 0.0:
        return max(cfg.csza, 1e-6), solfac
    if cfg.iday > 0:
        zen, _azi, sf = zensun(cfg.iday, cfg.time, cfg.alat, cfg.alon)
        return max(np.cos(np.deg2rad(zen)), 1e-6), solfac * sf
    return max(np.cos(np.deg2rad(cfg.sza)), 1e-6), solfac


# --------------------------------------------------------------------------
# Satellite filter functions (spectra.f:FILTER equivalent)
# --------------------------------------------------------------------------

# Built-in satellite channel responses (isat > 0), spectra.f:FILTER
# equivalent.  Curves are trapezoids on each instrument's PUBLISHED 50%-
# response band limits (lo50, hi50) [um] with 10%-of-width cosine-tapered
# edges — the band limits are documented instrument specifications; the
# exact measured response shapes await reference extraction (SURVEY 8.6).
_BUILTIN_FILTERS = {
    1: (0.45, 1.00, "METEOSAT visible"),
    2: (0.55, 0.75, "GOES visible (E)"),
    3: (0.55, 0.75, "GOES visible (W)"),
    4: (0.58, 0.68, "AVHRR ch1"),
    5: (0.725, 1.00, "AVHRR ch2"),
    6: (3.55, 3.93, "AVHRR ch3"),
    7: (10.3, 11.3, "AVHRR ch4"),
    8: (11.5, 12.5, "AVHRR ch5"),
    9: (5.7, 7.1, "METEOSAT water vapor"),
    10: (10.5, 12.5, "METEOSAT IR window"),
    11: (0.50, 0.90, "broadband visible/NIR"),
    12: (0.25, 4.0, "broadband shortwave"),
}


def filter_list() -> dict[int, str]:
    """isat code -> channel description (the built-in filter catalog)."""
    return {k: v[2] for k, v in _BUILTIN_FILTERS.items()}


def filter_function(
    cfg: Config,
    wl_um: np.ndarray,
    user_table: tuple[np.ndarray, np.ndarray] | None = None,
) -> np.ndarray:
    """Spectral filter weight in [0, 1] at wl_um."""
    wl = np.asarray(wl_um, np.float64)
    if cfg.isat == 0:
        return np.ones_like(wl)
    if cfg.isat == -1:
        if user_table is None:
            d = np.loadtxt("filter.dat")
            user_table = (d[:, 0], d[:, 1])
        return np.interp(wl, user_table[0], user_table[1], left=0.0, right=0.0)
    if cfg.isat in _BUILTIN_FILTERS:
        # measured-class tabulated curves where available (data/filters.py);
        # trapezoid-on-published-limits for the rest
        from rtbench.reference.data.filters import tabulated_response

        tab = tabulated_response(cfg.isat, wl)
        if tab is not None:
            return tab
        lo, hi, _name = _BUILTIN_FILTERS[cfg.isat]
        c = 0.5 * (lo + hi)
        wdt = hi - lo
        x = (wl - c) / (wdt / 2.0)         # +-1 at the 50% points
        ax = np.abs(x)
        resp = np.where(ax <= 0.9, 1.0, 0.0)
        edge = (ax > 0.9) & (ax < 1.1)
        resp = np.where(
            edge, 0.5 * (1 + np.cos(np.pi * (ax - 0.9) / 0.2)), resp
        )
        return resp
    raise ValueError(
        f"unsupported isat={cfg.isat}; built-ins: {filter_list()}"
    )


def spectral_grid(cfg: Config) -> np.ndarray:
    """Wavelength sample points [um] for the spectral loop.

    wlinc semantics (rt.doc): 0 -> default step (0.005 um below 2 um, else
    the k-band grid); > 0 -> step in um; in (-1, 0) -> |wlinc| step in
    wavenumber-equivalent; < -1 -> constant resolving power |wlinc|.
    """
    lo, hi = cfg.wlinf, cfg.wlsup
    if hi <= lo:
        return np.array([lo])
    if cfg.wlinc > 0:
        n = int(np.floor((hi - lo) / cfg.wlinc + 1.5))
        return lo + cfg.wlinc * np.arange(n)
    if cfg.wlinc <= -1:
        # step of |wlinc| in wavenumber [cm^-1]: nu grid descending
        dnu = abs(cfg.wlinc)
        nu_hi, nu_lo = 1e4 / lo, 1e4 / hi
        n = int(np.floor((nu_hi - nu_lo) / dnu + 1.5))
        return 1e4 / (nu_hi - dnu * np.arange(n))
    if cfg.wlinc < 0:
        # -1 < wlinc < 0: constant resolving power, dlam = |wlinc| * lam
        r = 1.0 / abs(cfg.wlinc)
        n = int(np.ceil(np.log(hi / lo) / np.log1p(1.0 / r))) + 1
        return lo * (1.0 + 1.0 / r) ** np.arange(n)
    # default: 0.005 um in the SW, 20 cm^-1-equivalent in the IR
    if hi <= 2.0:
        step = 0.005
        n = int(np.floor((hi - lo) / step + 1.5))
        return lo + step * np.arange(n)
    nu_hi, nu_lo = 1e4 / lo, 1e4 / hi
    dnu = 20.0
    n = int(np.floor((nu_hi - nu_lo) / dnu + 1.5))
    return np.sort(1e4 / (nu_hi - dnu * np.arange(n)))


__all__ = [
    "zensun",
    "solar_geometry",
    "solar_irradiance",
    "filter_function",
    "spectral_grid",
]
