# Frozen copy of sbdart_tpu_torch/rayleigh.py for the benchmark's reference: imports
# point into rtbench.reference.
# Later changes do not edit it.
"""Rayleigh scattering optical depth.

Replaces the Rayleigh block inside sbdart.f (SURVEY.md section 4.1).
Cross-section per unit pressure from the Hansen & Travis (1974) fit

    tau_R(lambda, whole column at 1013.25 mb)
        = 0.008569 lam^-4 (1 + 0.0113 lam^-2 + 0.00013 lam^-4)

distributed over layers proportionally to dp.  The `xrsc` namelist factor
scales it; pbar == 0 disables Rayleigh entirely (reference convention).

Phase function: pure Rayleigh moments (beta_2 = 0.1, depolarization 0),
matching disort.f:GETMOM's 'Rayleigh' branch.
"""

from __future__ import annotations

import numpy as np

from rtbench.reference.constants import P_STD_MB


def rayleigh_tau_column(wl_um: np.ndarray) -> np.ndarray:
    """Whole-column Rayleigh optical depth at 1013.25 mb surface pressure."""
    lam2 = np.asarray(wl_um, np.float64) ** -2
    return 0.008569 * lam2**2 * (1.0 + 0.0113 * lam2 + 0.00013 * lam2**2)


def rayleigh_layer_tau(wl_um, p_levels, xrsc: float = 1.0):
    """Per-layer Rayleigh optical depth.

    Args:
      wl_um: wavelengths [B...].
      p_levels: level pressures [mb], TOA-first [nlev].
    Returns:
      tau [B..., nlyr].
    """
    wl = np.asarray(wl_um, np.float64)
    dp = np.diff(np.asarray(p_levels, np.float64))  # [nlyr], positive
    col = rayleigh_tau_column(wl)
    return xrsc * col[..., None] * (dp / P_STD_MB)


RAYLEIGH_MOMENTS = np.array([1.0, 0.0, 0.1])


def rayleigh_moments(nmom: int) -> np.ndarray:
    out = np.zeros(nmom)
    out[: min(3, nmom)] = RAYLEIGH_MOMENTS[:nmom]
    return out
