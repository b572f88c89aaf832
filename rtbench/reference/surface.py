# Frozen copy of sbdart_tpu_torch/surface.py for the benchmark's reference: imports
# point into rtbench.reference.
# Later changes do not edit it.
"""Surface spectral albedo selection.

Replaces salbedo.f:SALBEDO (reference component #7): constant albedo,
built-in spectral curves, sand/vegetation/water/snow mixtures via `sc`, and
the user `albedo.dat` file.
"""

from __future__ import annotations

import numpy as np

from rtbench.reference.config import Config
from rtbench.reference.data.albedo import CURVES, WL


def load_albedo_dat(path: str) -> tuple[np.ndarray, np.ndarray]:
    d = np.loadtxt(path)
    return d[:, 0], d[:, 1]


def surface_albedo(
    cfg: Config,
    wl_um: np.ndarray,
    user_table: tuple[np.ndarray, np.ndarray] | None = None,
) -> np.ndarray:
    """Spectral surface albedo at wavelengths wl_um [B...]."""
    wl = np.asarray(wl_um, np.float64)
    isalb = cfg.isalb
    if isalb == 0:
        return np.full_like(wl, cfg.albcon)
    if isalb == -1:
        if user_table is None:
            user_table = load_albedo_dat("albedo.dat")
        uwl, ualb = user_table
        return np.interp(wl, uwl, ualb)
    if isalb in CURVES:
        return np.interp(wl, WL, CURVES[isalb])
    if isalb == 7:
        # mixture: sc = [sand, vegetation, ocean water, snow] fractions
        sc = np.asarray(cfg.sc[:4], np.float64)
        comps = np.stack(
            [
                np.interp(wl, WL, CURVES[5]),
                np.interp(wl, WL, CURVES[6]),
                np.interp(wl, WL, CURVES[4]),
                np.interp(wl, WL, CURVES[1]),
            ]
        )
        return np.einsum("c,c...->...", sc, comps)
    raise ValueError(f"unsupported isalb={isalb}")
