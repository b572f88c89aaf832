# Frozen copy of sbdart_tpu_torch/constants.py for the benchmark's reference: imports
# point into rtbench.reference.
# Later changes do not edit it.
"""Physical constants used across the framework.

Values follow CODATA-2018 where applicable.  The reference encodes the same
constants as literals scattered through sbdart.f / disort.f (e.g. the Planck
radiation constants in disort.f:PLKAVG); here they live in one module.
"""

from __future__ import annotations

# --- fundamental -----------------------------------------------------------
PLANCK_H = 6.62607015e-34       # J s
BOLTZMANN_K = 1.380649e-23      # J / K
SPEED_OF_LIGHT = 2.99792458e8   # m / s
STEFAN_BOLTZMANN = 5.670374419e-8  # W m^-2 K^-4
AVOGADRO = 6.02214076e23        # mol^-1

# Planck-function radiation constants (cgs-ish spectral forms in wavenumber):
#   B_nu(T) = C1 * nu^3 / (exp(C2 * nu / T) - 1)   [W m^-2 sr^-1 / cm^-1]
# with nu in cm^-1.  These are the constants disort.f:PLKAVG calls C1, C2.
C1_RADIATION = 2.0 * PLANCK_H * SPEED_OF_LIGHT**2 * 1.0e8   # W m^-2 sr^-1 cm^4 -> per cm^-1: 1.191042e-8
C2_RADIATION = PLANCK_H * SPEED_OF_LIGHT / BOLTZMANN_K * 100.0  # cm K = 1.438777

# --- geophysical -----------------------------------------------------------
GRAVITY = 9.80665               # m / s^2 (standard)
EARTH_RADIUS_KM = 6371.2        # km
P_STD_MB = 1013.25              # mb, standard surface pressure
T_STD_K = 273.15                # K
LOSCHMIDT = 2.6867811e19        # cm^-3 at STP (molecules / cm^3)
AIR_MOLAR_MASS = 28.9644        # g / mol
H2O_MOLAR_MASS = 18.01528      # g / mol
O3_MOLAR_MASS = 47.9982        # g / mol

# Solar constant used to normalize built-in solar spectra (total solar
# irradiance at 1 AU).  SBDART's LOWTRAN7 spectrum integrates to ~1368 W/m^2;
# we normalize our regenerated spectrum to the modern TSI value.
SOLAR_CONSTANT = 1361.0         # W / m^2

# Default conservative-scattering dither: DISORT dithers SSALB away from 1
# (disort.f: "dither" applied in SETDIS) because the eigenproblem is singular
# at omega0 == 1.  In f64 a much smaller dither than DISORT's f32 one works.
SSALB_DITHER = 1.0e-9
# Minimum layer optical depth used to avoid 0/0 in linear-in-tau Planck slopes.
DTAU_MIN = 1.0e-12

# Floor for the LINEAR-IN-TAU Planck slope denominator b1 = dB/dtau
# (round 5).  The slope amplifies the Planck function's rounding noise by
# 1/dtau and enters the BVP right-hand side through the thermal particular
# solution UNDAMPED by dtau, so optically thin thermal layers turn
# eps*B/dtau into O(B) flux noise (measured: 3x TOA-flux scatter between
# two correct f32 paths at dtau ~ 1e-5 in 20 cm^-1 water-vapor bands,
# +50% OLR on the f32 TPU pipeline for the subarctic-winter column).
# Sub-floor layers are treated as near-isothermal: their emission is
# O(dtau * B), so the linearization detail is physically irrelevant,
# while the noise amplification is capped at eps/floor (~1e-4 relative
# in f32, ~1e-8 in f64).
SLOPE_TAU_MIN_F32 = 1.0e-3
SLOPE_TAU_MIN_F64 = 1.0e-8


def slope_tau_floor(dtype):
    import torch

    return (SLOPE_TAU_MIN_F32 if dtype == torch.float32
            else SLOPE_TAU_MIN_F64)
