# Frozen copy of sbdart_tpu_torch/data/gas_bands20.py for the benchmark's reference: imports
# point into rtbench.reference.
# Later changes do not edit it.
"""20 cm^-1 Malkmus band tables for the six major absorbers.

Replaces the ~60 smooth band-scale envelopes of gas_bands.py for
H2O/CO2/O3/O2/CH4/N2O with tables on the reference's native 20 cm^-1 grid
(taugas.f evaluates LOWTRAN7 band transmissions at 20 cm^-1 — SURVEY.md
section 3, component 3).  Construction per gas:

  S(nu)  — mean absorption-coefficient spectral density, built from
           spectroscopic FEATURES (fundamentals, overtones, hot-band
           complexes).  Each feature carries its PUBLISHED integrated band
           intensity (HITRAN-class compilations; Goody & Yung "Atmospheric
           Radiation" tables; Rothman et al.) and a band-shape envelope
           with 20 cm^-1-scale structure: P/R doublet lobes, Q-branch
           spikes, exponential wings with measured extents.  The integral
           int S dnu over each feature EQUALS the published intensity by
           construction (tests/test_gas_bands20.py pins this).
  beta(nu) — Malkmus line-overlap parameter pi*gamma_L/d from the gas's
           mean line spacing d at the band (CO2 ~1.6 cm^-1, H2O rot ~10,
           O3 ~0.1, ...), times a per-gas CALIBRATION factor fitted so the
           round-2 flux anchors (Lacis-Hansen H2O absorptance, O2 per-band
           solar absorption, OLR/DLR LBL-class values) stay green.

What this is NOT: line-by-line data.  Within-band line-cluster structure
finer than the envelope model is not represented; the claim is correct
band EDGES, window boundaries, Q-branch positions and integrated
intensities at 20 cm^-1 sampling — swap in the reference's actual tables
for bit parity when the mount is populated (SURVEY.md section 8.6).

Units: S in (absorber unit)^-1 cm^... such that S*u is the dimensionless
band-mean optical depth per unit wavenumber; absorber units are g/cm^2 for
H2O, atm-cm for O3, 1e20 molec/cm^2 for the uniformly mixed gases
(matching gas.py's GasAmounts).  Published intensities are quoted in
cm^-2 atm^-1 at 296 K and converted:
  1 atm-cm = 2.6868e19 molec/cm^2  =>  x 3.7220 per 1e20 molec/cm^2
  1 g/cm^2 H2O = 3.346e22 molec/cm^2 = 1245.3 atm-cm
"""

from __future__ import annotations

import functools

import numpy as np

# ---------------------------------------------------------------------------
# grid
# ---------------------------------------------------------------------------

NU_MIN, NU_MAX, DNU = 100.0, 40000.0, 20.0
NU_GRID = np.arange(NU_MIN, NU_MAX + DNU / 2, DNU)        # [1996]

_PER_ATMCM_TO_PER_1E20 = 1.0e20 / 2.6868e19               # = 3.7220
_PER_ATMCM_TO_PER_GCM2_H2O = 1245.3

# ---------------------------------------------------------------------------
# envelopes (all normalized to unit integral on NU_GRID)
# ---------------------------------------------------------------------------


def _norm(f: np.ndarray) -> np.ndarray:
    s = np.trapezoid(f, NU_GRID)
    return f / max(s, 1e-300)


def pr_doublet(nu0: float, w: float, gap: float = 0.0, qfrac: float = 0.0,
               qwidth: float = 15.0) -> np.ndarray:
    """P/R-branch band: two exponential lobes +- around nu0.

    w: wing decay scale [cm^-1]; gap: P/R peak offset from center (the
    Q-branch gap of a parallel band); qfrac: fraction of intensity in a
    narrow Q-branch spike at nu0 (perpendicular bands).
    """
    d = np.abs(NU_GRID - nu0)
    lobe = np.where(d < gap, (d / max(gap, 1e-9)) ** 1.0, 1.0) * np.exp(
        -(np.maximum(d - gap, 0.0)) / w
    )
    f = _norm(lobe) * (1.0 - qfrac)
    if qfrac > 0:
        q = _norm(np.exp(-d / qwidth))
        f = f + qfrac * q
    return f


def asym_rot(peak: float, w_lo: float, w_hi: float) -> np.ndarray:
    """Asymmetric-rotor envelope: nu^2 rise to `peak`, PURE exponential
    decay above (the H2O pure-rotation band shape).  The decay must not
    carry the polynomial factor: (nu/peak)^2 exp(-d/w) leaves a flat
    ~1 (g/cm^2)^-1 pseudo-continuum across the 8-12 um window (measured:
    +23% spurious window absorption for a tropical column)."""
    nu = NU_GRID
    f = np.where(
        nu <= peak,
        (nu / peak) ** 2,
        np.exp(-(nu - peak) / w_hi),
    )
    return _norm(f)


def two_sided(nu0: float, w_lo: float, w_hi: float) -> np.ndarray:
    """Asymmetric exponential band (different low/high-side decay)."""
    d = NU_GRID - nu0
    f = np.where(d < 0, np.exp(d / w_lo), np.exp(-d / w_hi))
    return _norm(f)


# ---------------------------------------------------------------------------
# feature tables
#
# (center nu0 [cm^-1], intensity [cm^-2 atm^-1 at 296K], envelope, beta0)
# Intensities: HITRAN-class band sums as compiled in Goody & Yung (1989)
# Tables 5.1-5.3 and the LOWTRAN/HITRAN band summaries; entries marked ~
# are +-30-50% recollection-grade and are additionally pinned by the flux
# anchors of tests/test_gas_calibration.py.
# beta0 = pi*gamma_L(p0)/d with gamma_L ~ 0.07 cm^-1 and the gas's mean
# line spacing d at the band, then scaled by the per-gas CAL factor below.
# ---------------------------------------------------------------------------

H2O_FEATURES = [
    # pure rotation band: strongest H2O feature, peak ~ 150-250 cm^-1,
    # decaying through the far IR to the 8-12 um window
    dict(nu0=180.0, s_atm=520.0, env=lambda: asym_rot(180.0, 80.0, 71.0),
         beta=0.035),
    # nu2 bending band, 6.3 um
    dict(nu0=1595.0, s_atm=260.0, env=lambda: pr_doublet(1595.0, 48.0,
         gap=25.0), beta=0.06),
    # 2.7 um complex (nu1 + nu3 + overtone 2nu2)
    dict(nu0=3700.0, s_atm=290.0, env=lambda: pr_doublet(3700.0, 65.0,
         gap=30.0), beta=0.05),
    # SW overtone/combination bands (weaker; flux-anchored)
    dict(nu0=5350.0, s_atm=32.0, env=lambda: pr_doublet(5350.0, 110.0,
         gap=25.0), beta=0.04),                     # 1.87 um
    dict(nu0=7250.0, s_atm=25.0, env=lambda: pr_doublet(7250.0, 120.0,
         gap=25.0), beta=0.04),                     # 1.38 um
    dict(nu0=8800.0, s_atm=8.0, env=lambda: pr_doublet(8800.0, 110.0,
         gap=25.0), beta=0.035),                    # 1.14 um
    dict(nu0=10610.0, s_atm=3.0, env=lambda: pr_doublet(10610.0, 100.0,
         gap=25.0), beta=0.03),                     # 0.94 um
    dict(nu0=12150.0, s_atm=0.8, env=lambda: pr_doublet(12150.0, 90.0,
         gap=25.0), beta=0.03),                     # 0.82 um
    dict(nu0=13900.0, s_atm=0.3, env=lambda: pr_doublet(13900.0, 80.0,
         gap=25.0), beta=0.03),                     # 0.72 um
]

CO2_FEATURES = [
    # nu2 15 um complex (strong Q branch, hot bands spread the wings)
    dict(nu0=667.4, s_atm=240.0, env=lambda: pr_doublet(667.4, 32.0,
         gap=10.0, qfrac=0.30, qwidth=6.0), beta=0.14),
    # nu3 4.3 um: very strong, steep-edged parallel band
    dict(nu0=2349.0, s_atm=2700.0, env=lambda: pr_doublet(2349.0, 22.0,
         gap=14.0), beta=0.14),
    # 2.7 um Fermi pair
    dict(nu0=3660.0, s_atm=43.0, env=lambda: pr_doublet(3660.0, 35.0,
         gap=12.0), beta=0.12),
    # 2.0 um triad
    dict(nu0=5000.0, s_atm=1.5, env=lambda: pr_doublet(5000.0, 45.0,
         gap=12.0), beta=0.10),
    # 1.6 / 1.4 um weak combinations
    dict(nu0=6250.0, s_atm=0.06, env=lambda: pr_doublet(6250.0, 45.0,
         gap=12.0), beta=0.10),
    dict(nu0=7000.0, s_atm=0.02, env=lambda: pr_doublet(7000.0, 45.0,
         gap=12.0), beta=0.10),
    # 9.4 / 10.4 um hot (laser) bands — weak but in the window
    dict(nu0=1064.0, s_atm=0.02, env=lambda: pr_doublet(1064.0, 18.0,
         gap=8.0), beta=0.10),
    dict(nu0=961.0, s_atm=0.02, env=lambda: pr_doublet(961.0, 18.0,
         gap=8.0), beta=0.10),
    # 5.2 um minor
    dict(nu0=1930.0, s_atm=0.05, env=lambda: pr_doublet(1930.0, 30.0,
         gap=10.0), beta=0.10),
]

O3_FEATURES = [
    # nu3/nu1 9.6 um double band
    dict(nu0=1042.0, s_atm=300.0, env=lambda: pr_doublet(1042.0, 22.0,
         gap=8.0, qfrac=0.2, qwidth=8.0), beta=1.2),
    dict(nu0=1103.0, s_atm=30.0, env=lambda: pr_doublet(1103.0, 20.0,
         gap=8.0), beta=1.2),
    # nu2 14.3 um
    dict(nu0=701.0, s_atm=60.0, env=lambda: pr_doublet(701.0, 25.0,
         gap=8.0, qfrac=0.2, qwidth=8.0), beta=1.0),
    # 4.75 um combination
    dict(nu0=2110.0, s_atm=25.0, env=lambda: pr_doublet(2110.0, 28.0,
         gap=8.0), beta=0.8),
]

# O2 bands are magnetic-dipole/forbidden: intensities are NOT quoted from a
# band compilation; the strengths reproduce the published per-band SOLAR
# ABSORPTION magnitudes (A 2.5 W/m^2, B 0.5, gamma 0.2, 1.27 um 1.0 —
# round-2 calibration, tests/test_gas_calibration.py) through the same
# Malkmus machinery.  s_atm here is back-computed from those anchors.
O2_FEATURES = [
    dict(nu0=13121.0, s_atm=0.00155, env=lambda: pr_doublet(13121.0, 18.0,
         gap=10.0), beta=0.05),                     # A band 762 nm
    dict(nu0=14526.0, s_atm=0.00016, env=lambda: pr_doublet(14526.0, 18.0,
         gap=10.0), beta=0.05),                     # B band 688 nm
    dict(nu0=15903.0, s_atm=0.00004, env=lambda: pr_doublet(15903.0, 18.0,
         gap=10.0), beta=0.05),                     # gamma 629 nm
    dict(nu0=7874.0, s_atm=0.0007, env=lambda: pr_doublet(7874.0, 30.0,
         gap=12.0), beta=0.05),                     # a1Dg 1.27 um
]

CH4_FEATURES = [
    dict(nu0=1306.0, s_atm=140.0, env=lambda: pr_doublet(1306.0, 42.0,
         gap=0.0, qfrac=0.35, qwidth=10.0), beta=0.06),   # nu4 7.66 um
    dict(nu0=3019.0, s_atm=300.0, env=lambda: pr_doublet(3019.0, 48.0,
         gap=0.0, qfrac=0.35, qwidth=10.0), beta=0.06),   # nu3 3.31 um
    dict(nu0=4340.0, s_atm=25.0, env=lambda: pr_doublet(4340.0, 60.0,
         gap=0.0, qfrac=0.2, qwidth=12.0), beta=0.05),    # 2.3 um
    dict(nu0=6005.0, s_atm=4.0, env=lambda: pr_doublet(6005.0, 60.0,
         gap=0.0, qfrac=0.2, qwidth=12.0), beta=0.05),    # 1.66 um
]

N2O_FEATURES = [
    dict(nu0=2224.0, s_atm=1300.0, env=lambda: pr_doublet(2224.0, 18.0,
         gap=10.0), beta=0.26),                     # nu3 4.5 um (~)
    dict(nu0=1285.0, s_atm=240.0, env=lambda: pr_doublet(1285.0, 16.0,
         gap=10.0), beta=0.26),                     # nu1 7.78 um
    dict(nu0=589.0, s_atm=25.0, env=lambda: pr_doublet(589.0, 18.0,
         gap=8.0, qfrac=0.3, qwidth=6.0), beta=0.24),     # nu2 17 um
    dict(nu0=3481.0, s_atm=10.0, env=lambda: pr_doublet(3481.0, 20.0,
         gap=10.0), beta=0.2),                      # 2.87 um
    dict(nu0=2563.0, s_atm=5.0, env=lambda: pr_doublet(2563.0, 20.0,
         gap=10.0), beta=0.2),                      # 3.9 um
]

FEATURES20 = {
    "h2o": H2O_FEATURES, "co2": CO2_FEATURES, "o3": O3_FEATURES,
    "o2": O2_FEATURES, "ch4": CH4_FEATURES, "n2o": N2O_FEATURES,
}

# unit conversion per gas: published cm^-2 atm^-1 -> model absorber units
_UNIT = {
    "h2o": _PER_ATMCM_TO_PER_GCM2_H2O,
    "o3": 1.0,
    "co2": _PER_ATMCM_TO_PER_1E20,
    "o2": _PER_ATMCM_TO_PER_1E20,
    "ch4": _PER_ATMCM_TO_PER_1E20,
    "n2o": _PER_ATMCM_TO_PER_1E20,
}

# Per-gas beta calibration: FITTED so the integral anchors stay green with
# the published-intensity S tables — Lacis-Hansen H2O column absorptance,
# O2 per-band W/m^2, clear-sky OLR/DLR (round-5 margins on the
# two-parameter Curtis-Godson scheme: TRO +0.7/-2.0%, MLS +1.9/-1.6%,
# SAW -1.5/+2.4% vs ICRCCM-class values; tests/test_gas_calibration.py).
#
# WHAT THE FACTOR MEANS (round 5): pressure no longer hides here.  Since
# the two-parameter Curtis-Godson split (gas.py item 4), beta carries its
# (p + p_d)/p0 * (T0/T)^1/2 dependence EXPLICITLY per layer, so BETA_CAL
# is purely the envelope model-form correction: the per-feature beta
# values above are line-spacing estimates pi*gamma_L/d (e.g. CO2
# pi*0.07/1.56 = 0.141), and CAL < 1 compensates the band-shape
# envelopes concentrating S(nu) more than the real 20 cm^-1 structure
# does (a too-peaked S inflates absorption at fixed beta; shrinking beta
# restores the measured curve of growth).  Eliminating the factor was
# tried and REJECTED against the anchors: CAL = 1 for all gases gives
# OLR -7..-9%, SAW DLR +14%, Lacis-Hansen H2O +26% — evidence the
# residual is real model-form error, not a pressure artifact.  The factor
# is bounded within 2.5x of line-spacing spectroscopy by
# tests/test_band_absorptance.py::test_beta_bounded_by_line_spacing.
BETA_CAL = {
    "h2o": 0.5, "co2": 0.31, "o3": 0.3, "o2": 1.0, "ch4": 0.3, "n2o": 0.3,
}  # noqa: E501 — see fit provenance above


@functools.lru_cache(maxsize=None)
def tables20(gas: str) -> tuple[np.ndarray, np.ndarray]:
    """(S, beta) on NU_GRID for `gas` (model absorber units)."""
    feats = FEATURES20[gas]
    s = np.zeros_like(NU_GRID)
    sb = np.zeros_like(NU_GRID)
    unit = _UNIT[gas]
    cal = BETA_CAL[gas]
    for f in feats:
        prof = f["env"]() * f["s_atm"] * unit      # integral = intensity
        s += prof
        sb += prof * (f["beta"] * cal)
    beta = np.where(s > 0, sb / np.maximum(s, 1e-300), 0.1)
    return s, beta


def band_parameters20(gas: str, wl_um: np.ndarray):
    """(S, beta) interpolated from the 20 cm^-1 tables at wavelengths."""
    s_tab, b_tab = tables20(gas)
    nu = 1.0e4 / np.maximum(np.asarray(wl_um, np.float64), 1e-6)
    s = np.interp(nu, NU_GRID, s_tab, left=0.0, right=0.0)
    b = np.interp(nu, NU_GRID, b_tab, left=0.1, right=0.1)
    return s, b
