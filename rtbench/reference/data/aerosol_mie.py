# Frozen copy of sbdart_tpu_torch/data/aerosol_mie.py for the benchmark's reference: imports
# point into rtbench.reference.
# Later changes do not edit it.
"""Mie-derived aerosol optical-property tables (Shettle–Fenn models).

Replaces the hand-tuned spectral curves previously used for the four
boundary-layer models (tauaero.f / 5S component #5) with properties
COMPUTED from the published model microphysics:

  * lognormal size distributions with the Shettle & Fenn (1979, AFGL-TR-
    79-0214) modal parameters (mode radius, log-std, number mixing),
  * component refractive indices from the WCP-55 / d'Almeida et al. (1991)
    compilations (water-soluble, dust-like, soot, sea salt — approximate
    transcriptions, provenance per data/__init__.py),
  * hygroscopic growth by the Hanel power law r(RH) = r_dry (1-RH)^(-eps)
    with the wet refractive index volume-mixed with liquid water
    (data/refractive.py), the 5S treatment,
  * Bohren–Huffman Mie (data/mie.py:mie_batch) averaged over each mode.

Stratospheric models are computed the same way: 75% H2SO4 droplets
(background / aged volcanic), volcanic-ash spheres (fresh volcanic), and a
dust-like composition (meteoric dust).

Tables are generated once by `generate_aerosol_tables()` and committed as
`aerosol_mie.npz` (models x RH x wavelength: ext_rel, w0, g) so imports are
deterministic and fast.  `tables()` loads (or regenerates) them.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from rtbench.reference.data.mie import mie_batch
from rtbench.reference.data.refractive import water_index

_NPZ = os.path.join(os.path.dirname(__file__), "aerosol_mie.npz")

# table axes
WL_GRID = np.array([
    0.25, 0.30, 0.337, 0.40, 0.488, 0.55, 0.633, 0.694, 0.80, 0.86, 1.06,
    1.30, 1.536, 1.80, 2.00, 2.25, 2.50, 2.70, 3.00, 3.39, 3.75, 4.50,
    5.00, 5.50, 6.00, 6.50, 7.20, 8.00, 8.50, 9.00, 10.0, 11.5, 12.5,
    15.0, 17.5, 20.0, 25.0, 30.0, 40.0,
])
RH_GRID = np.array([0.0, 50.0, 70.0, 80.0, 90.0, 95.0, 98.0, 99.0])

# --------------------------------------------------------------------------
# Component dry refractive indices (wl um, n, k) — WCP-55/d'Almeida class.
# Coarse tables; log-interpolated in k, linear in n.
# --------------------------------------------------------------------------

_WASO = np.array([  # water-soluble (sulfate/nitrate/organics mixture)
    [0.25, 1.53, 3.0e-2], [0.30, 1.53, 8.0e-3], [0.40, 1.53, 5.0e-3],
    [0.55, 1.53, 6.0e-3], [0.70, 1.53, 7.0e-3], [1.00, 1.52, 1.7e-2],
    [1.50, 1.51, 2.0e-2], [2.00, 1.42, 8.0e-3], [2.50, 1.42, 1.2e-2],
    [3.00, 1.43, 8.0e-3], [3.50, 1.45, 5.0e-3], [4.00, 1.45, 1.3e-2],
    [5.00, 1.45, 1.2e-2], [6.00, 1.47, 2.5e-2], [7.00, 1.40, 5.5e-2],
    [8.00, 1.42, 4.0e-2], [9.00, 1.44, 5.5e-2], [10.0, 1.74, 2.9e-1],
    [12.0, 1.76, 2.5e-1], [15.0, 1.72, 2.0e-1], [20.0, 1.80, 2.0e-1],
    [30.0, 1.88, 3.0e-1], [40.0, 1.90, 4.0e-1],
])

_DUST = np.array([  # dust-like (silicate)
    [0.25, 1.53, 8.5e-3], [0.30, 1.53, 8.0e-3], [0.40, 1.53, 8.0e-3],
    [0.55, 1.53, 8.0e-3], [0.70, 1.53, 8.0e-3], [1.00, 1.52, 8.0e-3],
    [1.50, 1.42, 8.0e-3], [2.00, 1.26, 9.0e-3], [2.50, 1.18, 1.3e-2],
    [3.00, 1.16, 1.2e-2], [3.50, 1.22, 1.0e-2], [4.00, 1.26, 1.3e-2],
    [5.00, 1.28, 5.5e-2], [6.00, 1.26, 6.3e-2], [7.00, 1.17, 1.0e-1],
    [8.00, 1.25, 2.0e-1], [9.00, 2.00, 6.0e-1], [10.0, 1.85, 4.6e-1],
    [12.0, 1.96, 2.6e-1], [15.0, 1.75, 3.5e-1], [20.0, 1.92, 4.0e-1],
    [30.0, 1.86, 6.0e-1], [40.0, 2.10, 7.0e-1],
])

_SOOT = np.array([  # carbonaceous soot
    [0.25, 1.62, 4.5e-1], [0.30, 1.74, 4.7e-1], [0.40, 1.75, 4.6e-1],
    [0.55, 1.75, 4.4e-1], [0.70, 1.75, 4.3e-1], [1.00, 1.76, 4.4e-1],
    [1.50, 1.81, 4.9e-1], [2.00, 1.85, 5.4e-1], [2.50, 1.89, 5.7e-1],
    [3.00, 1.90, 5.7e-1], [4.00, 1.92, 5.6e-1], [5.00, 1.94, 5.7e-1],
    [6.00, 1.97, 6.0e-1], [8.00, 2.02, 6.7e-1], [10.0, 2.12, 7.3e-1],
    [15.0, 2.28, 8.6e-1], [20.0, 2.41, 9.6e-1], [30.0, 2.60, 1.1e0],
    [40.0, 2.75, 1.2e0],
])

_SALT = np.array([  # sea salt (dry)
    [0.25, 1.51, 5.0e-6], [0.30, 1.51, 2.0e-6], [0.40, 1.50, 3.0e-7],
    [0.55, 1.50, 1.0e-8], [0.70, 1.49, 1.0e-7], [1.00, 1.47, 2.0e-5],
    [1.50, 1.46, 5.0e-4], [2.00, 1.45, 1.0e-3], [2.50, 1.43, 3.0e-3],
    [3.00, 1.49, 1.0e-2], [3.50, 1.48, 4.0e-3], [4.00, 1.48, 6.0e-3],
    [5.00, 1.45, 1.5e-2], [6.00, 1.47, 1.5e-2], [7.00, 1.45, 2.0e-2],
    [8.00, 1.41, 3.5e-2], [9.00, 1.45, 5.0e-2], [10.0, 1.50, 7.0e-2],
    [12.0, 1.46, 1.0e-1], [15.0, 1.47, 2.0e-1], [20.0, 1.54, 5.0e-1],
    [30.0, 1.80, 1.0e0], [40.0, 1.90, 9.0e-1],
])

_H2SO4 = np.array([  # 75% sulfuric acid solution (stratospheric droplets)
    [0.25, 1.46, 1.0e-8], [0.40, 1.44, 1.0e-8], [0.55, 1.43, 1.0e-8],
    [0.70, 1.43, 2.0e-8], [1.00, 1.42, 1.5e-6], [1.50, 1.40, 1.3e-4],
    [2.00, 1.38, 1.0e-3], [2.50, 1.34, 5.5e-3], [3.00, 1.32, 1.3e-1],
    [3.50, 1.39, 1.2e-1], [4.00, 1.40, 1.3e-1], [5.00, 1.35, 1.3e-1],
    [6.00, 1.32, 1.5e-1], [7.00, 1.26, 1.5e-1], [8.00, 1.13, 2.5e-1],
    [9.00, 1.55, 7.0e-1], [9.80, 1.90, 5.0e-1], [11.0, 1.70, 2.0e-1],
    [12.0, 1.80, 3.0e-1], [15.0, 1.90, 3.5e-1], [20.0, 1.95, 4.5e-1],
    [30.0, 1.95, 5.5e-1], [40.0, 1.95, 6.5e-1],
])

_ASH = np.array([  # volcanic ash
    [0.25, 1.50, 5.0e-3], [0.40, 1.50, 5.0e-3], [0.55, 1.50, 5.0e-3],
    [0.70, 1.50, 5.0e-3], [1.00, 1.50, 5.0e-3], [1.50, 1.49, 5.0e-3],
    [2.00, 1.48, 6.0e-3], [3.00, 1.45, 8.0e-3], [4.00, 1.43, 1.0e-2],
    [5.00, 1.40, 3.0e-2], [6.00, 1.35, 5.0e-2], [7.00, 1.25, 8.0e-2],
    [8.00, 1.30, 2.0e-1], [9.00, 1.80, 5.0e-1], [10.0, 1.75, 4.0e-1],
    [12.0, 1.85, 3.0e-1], [15.0, 1.80, 3.5e-1], [20.0, 1.90, 4.0e-1],
    [30.0, 1.90, 5.0e-1], [40.0, 2.00, 6.0e-1],
])


def _index(table: np.ndarray, wl: np.ndarray) -> np.ndarray:
    n = np.interp(wl, table[:, 0], table[:, 1])
    k = np.exp(np.interp(np.log(wl), np.log(table[:, 0]),
                         np.log(table[:, 2])))
    return n + 1j * k   # mie_batch convention (matches refractive.py)


# --------------------------------------------------------------------------
# Shettle–Fenn model microphysics: lognormal modes.
#   rg: dry mode radius [um]; s10: log10 standard deviation;
#   nfrac: number fraction; comp: volume composition of dry material;
#   eps: Hanel hygroscopic-growth exponent (0 = hydrophobic).
# --------------------------------------------------------------------------

_RURAL_MIX = {"waso": 0.70, "dust": 0.30}   # volume mixture (S&F rural)
_URBAN_MIX = {"waso": 0.56, "dust": 0.24, "soot": 0.20}

BL_MODELS = {
    1: dict(name="rural", modes=[
        dict(rg=0.03, s10=0.35, nfrac=0.999875, comp=_RURAL_MIX, eps=0.25),
        dict(rg=0.50, s10=0.40, nfrac=1.25e-4, comp=_RURAL_MIX, eps=0.18),
    ]),
    2: dict(name="urban", modes=[
        dict(rg=0.025, s10=0.35, nfrac=0.999875, comp=_URBAN_MIX, eps=0.22),
        dict(rg=0.40, s10=0.40, nfrac=1.25e-4, comp=_URBAN_MIX, eps=0.16),
    ]),
    3: dict(name="oceanic", modes=[
        # 5S "oceanic" = the pure marine component (sea salt + water),
        # coarse lognormal; nearly flat spectral extinction (alpha ~ 0.1)
        dict(rg=0.30, s10=0.40, nfrac=1.0, comp={"salt": 1.0}, eps=0.29),
    ]),
    4: dict(name="tropospheric", modes=[
        dict(rg=0.03, s10=0.35, nfrac=1.0, comp=_RURAL_MIX, eps=0.25),
    ]),
}

STRAT_MODELS = {
    1: dict(name="background", rg=0.0725, s10=0.27, comp="h2so4"),
    2: dict(name="aged volcanic", rg=0.15, s10=0.25, comp="h2so4"),
    3: dict(name="fresh volcanic", rg=0.40, s10=0.35, comp="ash"),
    4: dict(name="meteoric dust", rg=0.50, s10=0.30, comp="dust"),
}

_COMP_TABLES = {"waso": _WASO, "dust": _DUST, "soot": _SOOT, "salt": _SALT,
                "h2so4": _H2SO4, "ash": _ASH}


def _dry_index(comp: dict[str, float] | str, wl: np.ndarray) -> np.ndarray:
    if isinstance(comp, str):
        return _index(_COMP_TABLES[comp], wl)
    m = np.zeros_like(wl, complex)
    for name, f in comp.items():
        m = m + f * _index(_COMP_TABLES[name], wl)
    return m


def _lognormal_nodes(rg: float, s10: float, nr: int = 48):
    """Radius nodes + number weights over a lognormal mode (log spacing)."""
    lns = s10 * np.log(10.0)
    u = np.linspace(-3.5 * lns, 3.5 * lns, nr)
    r = rg * np.exp(u)
    w = np.exp(-0.5 * (u / lns) ** 2)
    w /= np.trapezoid(w, u)
    return r, w, u


def _mode_optics(rg, lns_w, u, m, wl):
    """Cross sections per particle for one wet mode at one wavelength."""
    r, w = rg * np.exp(u), lns_w
    x = 2.0 * np.pi * r / wl
    qe, qs, gg = mie_batch(x, complex(m))
    a = np.pi * r**2
    cext = np.trapezoid(qe * a * w, u)
    csca = np.trapezoid(qs * a * w, u)
    cgsc = np.trapezoid(gg * qs * a * w, u)
    return cext, csca, cgsc


def _wet_mode(mode: dict, rh: float, wl: np.ndarray):
    """(cext, csca, g*csca) arrays over wl for one humidified mode."""
    eps = mode["eps"]
    rhc = min(rh, 99.0) / 100.0
    grow = (1.0 - rhc) ** (-eps) if eps > 0 else 1.0
    rg = mode["rg"] * grow
    fwater = 1.0 - grow**-3          # wet volume fraction that is water
    m_dry = _dry_index(mode["comp"], wl)
    m_wat = water_index(wl)
    m_wet = fwater * m_wat + (1.0 - fwater) * m_dry
    _, w, u = _lognormal_nodes(rg, mode["s10"])
    out = np.zeros((3, wl.size))
    for j, wlj in enumerate(wl):
        out[:, j] = _mode_optics(rg, w, u, m_wet[j], wlj)
    return out * mode["nfrac"]


def generate_aerosol_tables(progress: bool = False) -> dict:
    """Compute (ext_rel, w0, g)[model, rh, wl] for BL + strat models."""
    wl = WL_GRID
    nbl, nrh, nwl = len(BL_MODELS), len(RH_GRID), wl.size
    bl_ext = np.zeros((nbl, nrh, nwl))
    bl_w0 = np.zeros((nbl, nrh, nwl))
    bl_g = np.zeros((nbl, nrh, nwl))
    for i, (code, model) in enumerate(sorted(BL_MODELS.items())):
        for jr, rh in enumerate(RH_GRID):
            tot = np.zeros((3, nwl))
            for mode in model["modes"]:
                tot += _wet_mode(mode, rh, wl)
            cext, csca, cgsc = tot
            i55 = int(np.argmin(np.abs(wl - 0.55)))
            bl_ext[i, jr] = cext / cext[i55]
            bl_w0[i, jr] = np.clip(csca / np.maximum(cext, 1e-300), 0, 0.999999)
            bl_g[i, jr] = cgsc / np.maximum(csca, 1e-300)
            if progress:
                print(f"{model['name']} rh={rh}", flush=True)
    nst = len(STRAT_MODELS)
    st_ext = np.zeros((nst, nwl))
    st_w0 = np.zeros((nst, nwl))
    st_g = np.zeros((nst, nwl))
    for i, (code, model) in enumerate(sorted(STRAT_MODELS.items())):
        m = _dry_index(model["comp"], wl)
        _, w, u = _lognormal_nodes(model["rg"], model["s10"])
        tot = np.zeros((3, nwl))
        for j, wlj in enumerate(wl):
            tot[:, j] = _mode_optics(model["rg"], w, u, m[j], wlj)
        cext, csca, cgsc = tot
        i55 = int(np.argmin(np.abs(wl - 0.55)))
        st_ext[i] = cext / cext[i55]
        st_w0[i] = np.clip(csca / np.maximum(cext, 1e-300), 0, 0.999999)
        st_g[i] = cgsc / np.maximum(csca, 1e-300)
        if progress:
            print(model["name"], flush=True)
    return dict(wl=wl, rh=RH_GRID, bl_ext=bl_ext, bl_w0=bl_w0, bl_g=bl_g,
                st_ext=st_ext, st_w0=st_w0, st_g=st_g)


@functools.lru_cache(maxsize=None)
def tables() -> dict:
    if os.path.exists(_NPZ):
        with np.load(_NPZ) as z:
            t = {k: z[k] for k in z.files}
    else:
        t = generate_aerosol_tables()
        try:
            np.savez_compressed(_NPZ, **t)
        except OSError:
            pass
    # the cached dict of arrays is shared by ALL callers for the process
    # lifetime: freeze the arrays so an accidental in-place edit cannot
    # corrupt every later bl_model/strat_model lookup
    for arr in t.values():
        if isinstance(arr, np.ndarray):
            arr.setflags(write=False)
    return t


if __name__ == "__main__":
    t = generate_aerosol_tables(progress=True)
    np.savez_compressed(_NPZ, **t)
    print("saved", _NPZ)
