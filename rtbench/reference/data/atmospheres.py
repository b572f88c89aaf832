# Frozen copy of sbdart_tpu_torch/data/atmospheres.py for the benchmark's reference: imports
# point into rtbench.reference.
# Later changes do not edit it.
"""The six built-in model atmospheres — TRANSCRIBED published tables.

Replaces atms.f (reference component #2, SURVEY.md section 3): the
McClatchey et al. (1972) model atmospheres on the standard 33-level grid
(0-25 km by 1 km, then 30, 35, 40, 45, 50, 70, 100 km), providing z [km],
p [mb], T [K], water-vapor density [g/m^3] and ozone density [g/m^3], plus
uniformly-mixed trace-gas volume mixing ratios.

Provenance (round 5): idatm=1..5 are TRANSCRIBED from the McClatchey,
Fenn, Selby, Volz & Garing (1972, AFCRL-72-0497 "Optical Properties of
the Atmosphere", 3rd ed.) model-atmosphere tables, which are reproduced
verbatim in the LOWTRAN reports and standard radiative-transfer texts and
are the exact tables atms.f compiles in as DATA blocks.  idatm=6 uses the
TRANSCRIBED U.S. Standard Atmosphere 1976 z/T/p table (identical to the
US-1962 selection below 50 km at the digits printed) with the McClatchey
US-62 water-vapor/ozone columns.

Transcription self-checks (tests/test_physics_setup.py):
  * p/T: hydrostatic consistency — every layer below 50 km closes to
    < 0.8% (the residual of 3-significant-digit pressure rounding; the
    US76 table closes to < 3e-4 in its geopotential formulation).
    HIGH confidence.
  * wh: column integrals land within 2% of the published precipitable
    water (4.12 / 2.92 / 0.85 / 2.09 / 0.42 / 1.42 g/cm^2).  HIGH
    confidence.
  * wo: column integrals land within 8% of the published ozone columns;
    tropical/subarctic-winter/US-62 close to < 2.5%, midlat-winter and
    subarctic-summer to ~7% (2-significant-digit densities + coarse-grid
    trapezoid bias).  MODERATE confidence — swap in the reference DATA
    blocks for digit parity when the reference source is available
    (SURVEY section 8.6).

The densities are stored VERBATIM as transcribed (2 significant digits,
the precision the original prints); nothing is renormalized to the
published columns — a transcription error must show up in the self-checks,
not be hidden by a rescale.

idatm codes (sbdart.f convention): 1 tropical, 2 midlatitude summer,
3 midlatitude winter, 4 subarctic summer, 5 subarctic winter, 6 US
standard.
"""

from __future__ import annotations

import functools

import numpy as np

# standard 33-level altitude grid [km]
Z33 = np.array(
    [float(i) for i in range(26)] + [30.0, 35.0, 40.0, 45.0, 50.0, 70.0, 100.0]
)

# Uniformly mixed gas default volume mixing ratios (ppv).  SBDART's defaults
# (rt.doc; xco2 etc. scale these).
MIXING_RATIOS = {
    "n2": 0.781,
    "o2": 0.209,
    "co2": 360.0e-6,
    "ch4": 1.74e-6,
    "n2o": 0.32e-6,
    "co": 0.15e-6,
    "no2": 2.3e-11,
    "so2": 3.0e-10,
    "nh3": 5.0e-10,
    "no": 3.0e-10,
    "hno3": 5.0e-11,
}

# g/cm^3 of pure ozone at STP (48.00 g/mol / 22414 cm^3/mol), for the
# atm-cm <-> g/cm^2 column conversion.  (Round 5 fix: this was 2.1415e-2 —
# 10x too large — through round 4.  The error cancelled internally for the
# REGENERATED model profiles, which were normalized through the same
# constant, but made user atms.dat ozone amounts 10x too small; see
# tests/test_physics_setup.py::test_user_profile_ozone_amount.)
O3_DENSITY_STP = 2.1415e-3

# published column amounts (precipitable water g/cm^2, ozone atm-cm) —
# the self-check targets; widely quoted with the McClatchey tables
PUBLISHED_H2O_COLUMN = {1: 4.12, 2: 2.92, 3: 0.85, 4: 2.09, 5: 0.42, 6: 1.42}
PUBLISHED_O3_COLUMN = {1: 0.247, 2: 0.331, 3: 0.376, 4: 0.344, 5: 0.480,
                       6: 0.349}

# ---------------------------------------------------------------------------
# TRANSCRIBED TABLES — columns: p [mb], T [K], wh [g/m^3], wo [g/m^3] on Z33
# (surface-first here; model_atmosphere returns TOA-first).
# McClatchey et al. (1972), Tables 1-6 class data.
# ---------------------------------------------------------------------------

# idatm=1: TROPICAL
_TROPICAL = np.array([
    # p        T      wh      wo
    [1013.0, 300.0, 1.9e+1, 5.6e-5],   # 0 km
    [904.0,  294.0, 1.3e+1, 5.6e-5],   # 1
    [805.0,  288.0, 9.3e+0, 5.4e-5],   # 2
    [715.0,  284.0, 4.7e+0, 5.1e-5],   # 3
    [633.0,  277.0, 2.2e+0, 4.7e-5],   # 4
    [559.0,  270.0, 1.5e+0, 4.5e-5],   # 5
    [492.0,  264.0, 8.5e-1, 4.3e-5],   # 6
    [432.0,  257.0, 4.7e-1, 4.1e-5],   # 7
    [378.0,  250.0, 2.5e-1, 3.9e-5],   # 8
    [329.0,  244.0, 1.2e-1, 3.9e-5],   # 9
    [286.0,  237.0, 5.0e-2, 3.9e-5],   # 10
    [247.0,  230.0, 1.7e-2, 4.1e-5],   # 11
    [213.0,  224.0, 6.0e-3, 4.3e-5],   # 12
    [182.0,  217.0, 1.8e-3, 4.5e-5],   # 13
    [156.0,  210.0, 1.0e-3, 4.5e-5],   # 14
    [132.0,  204.0, 7.6e-4, 4.7e-5],   # 15
    [111.0,  197.0, 6.4e-4, 4.7e-5],   # 16
    [93.7,   195.0, 5.6e-4, 6.9e-5],   # 17
    [78.9,   199.0, 5.0e-4, 9.0e-5],   # 18
    [66.6,   203.0, 4.9e-4, 1.4e-4],   # 19
    [56.5,   207.0, 4.5e-4, 1.9e-4],   # 20
    [48.0,   211.0, 5.1e-4, 2.4e-4],   # 21
    [40.9,   215.0, 5.1e-4, 2.8e-4],   # 22
    [35.0,   217.0, 5.4e-4, 3.2e-4],   # 23
    [30.0,   219.0, 6.0e-4, 3.4e-4],   # 24
    [25.7,   221.0, 6.7e-4, 3.4e-4],   # 25
    [12.2,   232.0, 3.6e-4, 2.4e-4],   # 30
    [6.00,   243.0, 1.1e-4, 9.2e-5],   # 35
    [3.05,   254.0, 4.3e-5, 4.1e-5],   # 40
    [1.59,   265.0, 1.9e-5, 1.3e-5],   # 45
    [0.854,  270.0, 6.3e-6, 4.3e-6],   # 50
    [0.0579, 219.0, 1.4e-7, 8.6e-8],   # 70
    [3.00e-4, 210.0, 1.0e-9, 4.3e-11],  # 100
])

# idatm=2: MIDLATITUDE SUMMER
_MIDLAT_SUMMER = np.array([
    [1013.0, 294.0, 1.4e+1, 6.0e-5],
    [902.0,  290.0, 9.3e+0, 6.0e-5],
    [802.0,  285.0, 5.9e+0, 6.0e-5],
    [710.0,  279.0, 3.3e+0, 6.2e-5],
    [628.0,  273.0, 1.9e+0, 6.4e-5],
    [554.0,  267.0, 1.0e+0, 6.6e-5],
    [487.0,  261.0, 6.1e-1, 6.9e-5],
    [426.0,  255.0, 3.7e-1, 7.5e-5],
    [372.0,  248.0, 2.1e-1, 7.9e-5],
    [324.0,  242.0, 1.2e-1, 8.6e-5],
    [281.0,  235.0, 6.4e-2, 9.0e-5],
    [243.0,  229.0, 2.2e-2, 1.1e-4],
    [209.0,  222.0, 6.0e-3, 1.2e-4],
    [179.0,  216.0, 1.8e-3, 1.5e-4],
    [153.0,  216.0, 1.0e-3, 1.8e-4],
    [130.0,  216.0, 7.6e-4, 1.9e-4],
    [111.0,  216.0, 6.4e-4, 2.1e-4],
    [95.0,   216.0, 5.6e-4, 2.4e-4],
    [81.2,   216.0, 5.0e-4, 2.8e-4],
    [69.5,   217.0, 4.9e-4, 3.2e-4],
    [59.5,   218.0, 4.5e-4, 3.4e-4],
    [51.0,   219.0, 5.1e-4, 3.6e-4],
    [43.7,   220.0, 5.1e-4, 3.6e-4],
    [37.6,   222.0, 5.4e-4, 3.4e-4],
    [32.2,   223.0, 6.0e-4, 3.2e-4],
    [27.7,   224.0, 6.7e-4, 3.0e-4],
    [13.2,   234.0, 3.6e-4, 2.0e-4],
    [6.52,   245.0, 1.1e-4, 9.2e-5],
    [3.33,   258.0, 4.3e-5, 4.1e-5],
    [1.76,   270.6, 1.9e-5, 1.3e-5],
    [0.951,  276.0, 6.3e-6, 4.3e-6],
    [0.0671, 218.0, 1.4e-7, 8.6e-8],
    [3.00e-4, 210.0, 1.0e-9, 4.3e-11],
])

# idatm=3: MIDLATITUDE WINTER
_MIDLAT_WINTER = np.array([
    [1018.0, 272.2, 3.5e+0, 6.0e-5],
    [897.3,  268.7, 2.5e+0, 5.4e-5],
    [789.7,  265.2, 1.8e+0, 4.9e-5],
    [693.8,  261.7, 1.2e+0, 4.9e-5],
    [608.1,  255.7, 6.6e-1, 4.9e-5],
    [531.3,  249.7, 3.8e-1, 5.8e-5],
    [462.7,  243.7, 2.1e-1, 6.4e-5],
    [401.6,  237.7, 8.5e-2, 7.7e-5],
    [347.3,  231.7, 3.5e-2, 9.0e-5],
    [299.2,  225.7, 1.6e-2, 1.2e-4],
    [256.8,  219.7, 7.5e-3, 1.6e-4],
    [219.9,  219.2, 6.9e-3, 2.1e-4],
    [188.2,  218.7, 6.0e-3, 2.6e-4],
    [161.0,  218.2, 1.8e-3, 3.0e-4],
    [137.8,  217.7, 1.0e-3, 3.2e-4],
    [117.8,  217.2, 7.6e-4, 3.4e-4],
    [100.7,  216.7, 6.4e-4, 3.6e-4],
    [86.1,   216.2, 5.6e-4, 3.9e-4],
    [73.5,   215.7, 5.0e-4, 4.1e-4],
    [62.8,   215.2, 4.9e-4, 4.3e-4],
    [53.7,   215.2, 4.5e-4, 4.5e-4],
    [45.8,   215.2, 5.1e-4, 4.3e-4],
    [39.1,   215.2, 5.1e-4, 4.3e-4],
    [33.4,   215.2, 5.4e-4, 3.9e-4],
    [28.6,   215.2, 6.0e-4, 3.6e-4],
    [24.3,   215.2, 6.7e-4, 3.4e-4],
    [11.1,   217.4, 3.6e-4, 1.9e-4],
    [5.18,   227.8, 1.1e-4, 9.2e-5],
    [2.53,   243.2, 4.3e-5, 4.1e-5],
    [1.29,   258.5, 1.9e-5, 1.3e-5],
    [0.682,  265.7, 6.3e-6, 4.3e-6],
    [0.0467, 230.7, 1.4e-7, 8.6e-8],
    [3.00e-4, 210.2, 1.0e-9, 4.3e-11],
])

# idatm=4: SUBARCTIC SUMMER
_SUBARCTIC_SUMMER = np.array([
    [1010.0, 287.0, 9.1e+0, 4.9e-5],
    [896.0,  282.0, 6.0e+0, 5.4e-5],
    [792.9,  276.0, 4.2e+0, 5.6e-5],
    [700.0,  271.0, 2.7e+0, 5.8e-5],
    [616.0,  266.0, 1.7e+0, 6.0e-5],
    [541.0,  260.0, 1.0e+0, 6.4e-5],
    [473.0,  253.0, 5.4e-1, 7.1e-5],
    [413.0,  246.0, 2.9e-1, 7.5e-5],
    [359.0,  239.0, 1.3e-1, 7.9e-5],
    [310.7,  232.0, 4.2e-2, 1.1e-4],
    [267.7,  225.0, 1.5e-2, 1.3e-4],
    [230.0,  225.0, 9.4e-3, 1.8e-4],
    [197.7,  225.0, 6.0e-3, 2.1e-4],
    [170.0,  225.0, 1.8e-3, 2.6e-4],
    [146.0,  225.0, 1.0e-3, 2.8e-4],
    [125.0,  225.0, 7.6e-4, 3.2e-4],
    [108.0,  225.0, 6.4e-4, 3.4e-4],
    [92.8,   225.0, 5.6e-4, 3.9e-4],
    [79.8,   225.0, 5.0e-4, 4.1e-4],
    [68.6,   225.0, 4.9e-4, 4.1e-4],
    [58.9,   225.0, 4.5e-4, 3.9e-4],
    [50.7,   225.0, 5.1e-4, 3.6e-4],
    [43.6,   225.0, 5.1e-4, 3.4e-4],
    [37.5,   225.0, 5.4e-4, 3.2e-4],
    [32.27,  226.0, 6.0e-4, 3.0e-4],
    [27.8,   228.0, 6.7e-4, 2.8e-4],
    [13.4,   235.0, 3.6e-4, 1.9e-4],
    [6.61,   247.0, 1.1e-4, 9.2e-5],
    [3.40,   262.0, 4.3e-5, 4.1e-5],
    [1.81,   274.0, 1.9e-5, 1.3e-5],
    [0.987,  277.0, 6.3e-6, 4.3e-6],
    [0.0707, 216.0, 1.4e-7, 8.6e-8],
    [3.00e-4, 210.0, 1.0e-9, 4.3e-11],
])

# idatm=5: SUBARCTIC WINTER
_SUBARCTIC_WINTER = np.array([
    [1013.0, 257.1, 1.2e+0, 4.1e-5],
    [887.8,  259.1, 1.2e+0, 4.1e-5],
    [777.5,  255.9, 9.4e-1, 4.1e-5],
    [679.8,  252.7, 6.8e-1, 4.3e-5],
    [593.2,  247.7, 4.1e-1, 4.5e-5],
    [515.8,  240.9, 2.0e-1, 4.7e-5],
    [446.7,  234.1, 9.8e-2, 4.9e-5],
    [385.3,  227.3, 5.4e-2, 7.1e-5],
    [330.8,  220.6, 1.1e-2, 9.0e-5],
    [282.9,  217.2, 8.4e-3, 1.6e-4],
    [241.8,  217.2, 5.5e-3, 2.4e-4],
    [206.7,  217.2, 3.8e-3, 3.2e-4],
    [176.6,  217.2, 2.6e-3, 4.3e-4],
    [151.0,  217.2, 1.8e-3, 4.7e-4],
    [129.1,  217.2, 1.0e-3, 4.9e-4],
    [110.3,  217.2, 7.6e-4, 5.6e-4],
    [94.31,  216.6, 6.4e-4, 6.2e-4],
    [80.58,  216.0, 5.6e-4, 6.2e-4],
    [68.82,  215.4, 5.0e-4, 6.2e-4],
    [58.75,  214.8, 4.9e-4, 6.0e-4],
    [50.14,  214.1, 4.5e-4, 5.6e-4],
    [42.77,  213.6, 5.1e-4, 5.1e-4],
    [36.47,  213.0, 5.1e-4, 4.7e-4],
    [31.09,  212.4, 5.4e-4, 4.3e-4],
    [26.49,  211.8, 6.0e-4, 3.6e-4],
    [22.56,  211.2, 6.7e-4, 3.2e-4],
    [10.2,   216.0, 3.6e-4, 1.5e-4],
    [4.701,  222.2, 1.1e-4, 9.2e-5],
    [2.243,  234.7, 4.3e-5, 4.1e-5],
    [1.113,  247.0, 1.9e-5, 1.3e-5],
    [0.5719, 259.3, 6.3e-6, 4.3e-6],
    [0.0299, 245.7, 1.4e-7, 8.6e-8],
    [3.00e-4, 210.0, 1.0e-9, 4.3e-11],
])

MCCLATCHEY_TABLES = {
    1: _TROPICAL,
    2: _MIDLAT_SUMMER,
    3: _MIDLAT_WINTER,
    4: _SUBARCTIC_SUMMER,
    5: _SUBARCTIC_WINTER,
}

# ---------------------------------------------------------------------------
# TRANSCRIBED PUBLISHED TABLE (round 4): U.S. Standard Atmosphere 1976
# (NOAA/NASA/USAF, 1976) — z [km], T [K], p [mb] at the 33-level grid.
# idatm=6 (the reference's US-1962 selection) uses these in place of the
# US-62 digits: USSA-1962 and -1976 are identical below 50 km to the
# digits printed here.  tests/test_physics_setup.py pins a sample.
# ---------------------------------------------------------------------------
US76_TABLE = np.array([
    # z      T [K]     p [mb]
    [0.0,  288.15, 1013.25],
    [1.0,  281.65,  898.76],
    [2.0,  275.15,  795.01],
    [3.0,  268.66,  701.21],
    [4.0,  262.17,  616.60],
    [5.0,  255.68,  540.48],
    [6.0,  249.19,  472.17],
    [7.0,  242.70,  411.05],
    [8.0,  236.21,  356.51],
    [9.0,  229.73,  308.00],
    [10.0, 223.25,  264.99],
    [11.0, 216.77,  226.99],
    [12.0, 216.65,  193.99],
    [13.0, 216.65,  165.79],
    [14.0, 216.65,  141.70],
    [15.0, 216.65,  121.11],
    [16.0, 216.65,  103.52],
    [17.0, 216.65,   88.497],
    [18.0, 216.65,   75.652],
    [19.0, 216.65,   64.674],
    [20.0, 216.65,   55.293],
    [21.0, 217.58,   47.289],
    [22.0, 218.57,   40.475],
    [23.0, 219.57,   34.668],
    [24.0, 220.56,   29.717],
    [25.0, 221.55,   25.492],
    [30.0, 226.51,   11.970],
    [35.0, 236.51,    5.746],
    [40.0, 250.35,    2.871],
    [45.0, 264.16,    1.491],
    [50.0, 270.65,    0.79779],
    [70.0, 219.59,    0.052209],
    [100.0, 195.08,   0.00032011],
])

# idatm=6 water-vapor / ozone densities [g/m^3] on Z33 — TRANSCRIBED from
# the McClatchey US Standard 1962 table (column self-check: 1.44 g/cm^2
# water vs published 1.42; ozone 0.349 atm-cm vs published 0.349).
US62_WH = np.array([
    5.9e+0, 4.2e+0, 2.9e+0, 1.8e+0, 1.1e+0, 6.4e-1, 3.8e-1, 2.1e-1,
    1.2e-1, 4.6e-2, 1.8e-2, 8.2e-3, 3.7e-3, 1.8e-3, 8.4e-4, 7.2e-4,
    6.1e-4, 5.2e-4, 4.4e-4, 4.4e-4, 4.4e-4, 4.8e-4, 5.2e-4, 5.7e-4,
    6.1e-4, 6.6e-4, 3.8e-4, 1.6e-4, 6.7e-5, 3.2e-5, 1.2e-5, 1.5e-7,
    1.0e-9,
])
US62_WO = np.array([
    5.4e-5, 5.4e-5, 5.4e-5, 5.0e-5, 4.6e-5, 4.6e-5, 4.5e-5, 4.9e-5,
    5.2e-5, 7.1e-5, 9.0e-5, 1.3e-4, 1.6e-4, 1.7e-4, 1.9e-4, 2.1e-4,
    2.4e-4, 2.8e-4, 3.2e-4, 3.5e-4, 3.8e-4, 3.8e-4, 3.9e-4, 3.8e-4,
    3.6e-4, 3.4e-4, 2.0e-4, 1.1e-4, 4.9e-5, 1.7e-5, 4.0e-6, 8.6e-8,
    4.3e-11,
])


@functools.lru_cache(maxsize=None)
def model_atmosphere(idatm: int) -> dict:
    """Return dict(z[km], p[mb], t[K], wh[g/m^3], wo[g/m^3]) on 33 levels.

    Convention: levels ordered top-of-atmosphere first (z descending), the
    same as SBDART's internal ordering (atms.f stores TOA-first).
    """
    if idatm not in (1, 2, 3, 4, 5, 6):
        raise ValueError(f"idatm must be 1..6, got {idatm}")
    z = Z33
    if idatm == 6:
        assert np.allclose(US76_TABLE[:, 0], z)
        t = US76_TABLE[:, 1].copy()
        p = US76_TABLE[:, 2].copy()
        wh = US62_WH.copy()
        wo = US62_WO.copy()
    else:
        tab = MCCLATCHEY_TABLES[idatm]
        p = tab[:, 0].copy()
        t = tab[:, 1].copy()
        wh = tab[:, 2].copy()
        wo = tab[:, 3].copy()
    order = np.argsort(z)[::-1]
    return {
        "z": z[order].copy(),
        "p": p[order].copy(),
        "t": t[order].copy(),
        "wh": wh[order].copy(),
        "wo": wo[order].copy(),
    }
