"""The spectral helpers of the reference's batch (batch.py): the
trapezoid weights of the spectral integrals, each sample's band edges
in wavenumber and the mask of the samples with a thermal source.
Frozen copies of the program's sbdart_tpu_torch/pipeline.py helpers as
they stood when this benchmark was written.  Later PRs do not edit this
file.
"""

from __future__ import annotations

import numpy as np

THERMAL_WL_UM = 2.0


def trapz_weights(wl: np.ndarray) -> np.ndarray:
    if len(wl) == 1:
        return np.ones(1)
    w = np.zeros_like(wl)
    d = np.diff(wl)
    w[0] = d[0] / 2
    w[-1] = d[-1] / 2
    w[1:-1] = (d[:-1] + d[1:]) / 2
    return w


def band_edges_wavenumber(wl: np.ndarray):
    nu = 1.0e4 / wl
    if len(wl) == 1:
        half = 0.5 * max(nu[0] * 1e-3, 1.0)
        return nu - half, nu + half
    mid = 0.5 * (nu[1:] + nu[:-1])
    lo_e = np.empty_like(nu)
    hi_e = np.empty_like(nu)
    hi_e[0] = nu[0] + abs(nu[0] - mid[0])
    lo_e[-1] = nu[-1] - abs(mid[-1] - nu[-1])
    lo_e[:-1] = mid
    hi_e[1:] = mid
    return np.minimum(lo_e, hi_e), np.maximum(lo_e, hi_e)


def thermal_mask(cfg, wl: np.ndarray) -> np.ndarray:
    if cfg.nothrm == 0:
        return np.ones(len(wl), bool)
    if cfg.nothrm == 1:
        return np.zeros(len(wl), bool)
    return wl > THERMAL_WL_UM
