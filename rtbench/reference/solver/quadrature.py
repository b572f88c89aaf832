# Frozen copy of sbdart_tpu_torch/solver/quadrature.py for the benchmark's reference: imports
# point into rtbench.reference.
# Later changes do not edit it.
"""Angular quadrature for the discrete-ordinates method.

Replaces disort.f:QGAUSN (Gauss–Legendre points/weights on (0,1)).  DISORT
uses the "double-Gauss" scheme: an N-point Gauss–Legendre rule on (0,1)
applied to each polar hemisphere separately (N = nstr/2 streams per
hemisphere), which integrates hemispheric fluxes exactly and decouples the
hemispheres at mu=0.

Computed host-side with numpy at trace time (quadrature depends only on the
static `nstr`), so nothing here touches the device hot path.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def gauss_half_range(n: int) -> tuple[np.ndarray, np.ndarray]:
    """N-point Gauss–Legendre rule mapped from (-1,1) to (0,1).

    Returns (mu, w) as float64 arrays sorted ascending; sum(w) == 1 and
    sum(w * mu) == 1/2 to machine precision (hemispheric flux exactness).
    Equivalent to disort.f:QGAUSN.
    """
    if n < 1:
        raise ValueError(f"need >= 1 quadrature point, got {n}")
    x, w = np.polynomial.legendre.leggauss(n)
    mu = 0.5 * (x + 1.0)
    w = 0.5 * w
    order = np.argsort(mu)
    return mu[order], w[order]


@functools.lru_cache(maxsize=None)
def double_gauss(nstr: int) -> tuple[np.ndarray, np.ndarray]:
    """Double-Gauss quadrature for `nstr` total streams.

    Returns (mu, w) for the positive hemisphere only, shape (nstr//2,);
    the negative hemisphere mirrors it.  `nstr` must be even and >= 2.
    """
    if nstr < 2 or nstr % 2 != 0:
        raise ValueError(f"nstr must be even and >= 2, got {nstr}")
    return gauss_half_range(nstr // 2)
