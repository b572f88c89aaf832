# Frozen copy of sbdart_tpu_torch/data/albedo.py for the benchmark's reference: imports
# point into rtbench.reference.
# Later changes do not edit it.
"""Built-in surface spectral albedos.

Replaces salbedo.f's DATA curves (reference component #7).  REGENERATED
(see data/__init__.py): tabulated from the published shapes of the standard
surface types (snow: Wiscombe–Warren-class; water: Segelstein-derived;
sand/vegetation: ASTER-library-class curves).  Values are representative,
not bit-identical to the reference tables.

isalb codes: 1 snow, 2 clear water, 3 lake water, 4 sea water, 5 sand,
6 vegetation.
"""

from __future__ import annotations

import numpy as np

# wavelength grid [um] for all curves
WL = np.array(
    [0.25, 0.30, 0.35, 0.40, 0.45, 0.50, 0.55, 0.60, 0.65, 0.70, 0.75,
     0.80, 0.90, 1.00, 1.10, 1.20, 1.30, 1.40, 1.50, 1.60, 1.80, 2.00,
     2.20, 2.50, 3.00, 3.50, 4.00, 5.00, 10.0, 20.0, 40.0, 100.0]
)

_SNOW = np.array(
    [0.95, 0.96, 0.97, 0.97, 0.97, 0.97, 0.96, 0.95, 0.94, 0.92, 0.90,
     0.88, 0.82, 0.72, 0.60, 0.45, 0.35, 0.18, 0.12, 0.14, 0.08, 0.10,
     0.12, 0.05, 0.03, 0.02, 0.02, 0.02, 0.02, 0.02, 0.02, 0.02]
)

_CLEAR_WATER = np.array(
    [0.068, 0.067, 0.066, 0.065, 0.063, 0.061, 0.059, 0.057, 0.055, 0.053,
     0.051, 0.049, 0.045, 0.042, 0.040, 0.038, 0.036, 0.034, 0.032, 0.031,
     0.028, 0.026, 0.024, 0.022, 0.020, 0.018, 0.016, 0.014, 0.010, 0.008,
     0.006, 0.005]
)

_LAKE_WATER = np.array(
    [0.075, 0.077, 0.080, 0.085, 0.090, 0.093, 0.090, 0.085, 0.078, 0.070,
     0.062, 0.055, 0.043, 0.036, 0.032, 0.029, 0.026, 0.024, 0.022, 0.021,
     0.018, 0.016, 0.014, 0.012, 0.010, 0.009, 0.008, 0.007, 0.006, 0.005,
     0.005, 0.005]
)

_SEA_WATER = np.array(
    [0.070, 0.069, 0.068, 0.066, 0.064, 0.062, 0.060, 0.058, 0.056, 0.054,
     0.052, 0.050, 0.046, 0.043, 0.041, 0.039, 0.037, 0.035, 0.033, 0.032,
     0.029, 0.027, 0.025, 0.023, 0.021, 0.019, 0.017, 0.015, 0.011, 0.009,
     0.007, 0.006]
)

_SAND = np.array(
    [0.08, 0.10, 0.14, 0.18, 0.23, 0.28, 0.32, 0.36, 0.39, 0.41, 0.42,
     0.43, 0.44, 0.45, 0.46, 0.46, 0.46, 0.45, 0.45, 0.45, 0.43, 0.40,
     0.38, 0.32, 0.15, 0.10, 0.08, 0.05, 0.04, 0.03, 0.02, 0.02]
)

_VEGETATION = np.array(
    [0.03, 0.04, 0.05, 0.05, 0.07, 0.09, 0.10, 0.08, 0.06, 0.15, 0.40,
     0.45, 0.47, 0.46, 0.45, 0.43, 0.41, 0.30, 0.25, 0.28, 0.22, 0.12,
     0.10, 0.07, 0.04, 0.03, 0.03, 0.02, 0.02, 0.02, 0.02, 0.02]
)

CURVES = {
    1: _SNOW,
    2: _CLEAR_WATER,
    3: _LAKE_WATER,
    4: _SEA_WATER,
    5: _SAND,
    6: _VEGETATION,
}
