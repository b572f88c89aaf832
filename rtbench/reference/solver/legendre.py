# Frozen copy of sbdart_tpu_torch/solver/legendre.py for the benchmark's reference: imports
# point into rtbench.reference.
# Later changes do not edit it.
"""Normalized associated Legendre polynomials.

Replaces disort.f:LEPOLY.  For azimuth Fourier mode m the DOM needs

    Lam_l^m(mu) = sqrt((l-m)! / (l+m)!) * P_l^m(mu)

(no Condon–Shortley phase, matching DISORT's convention) evaluated at the
quadrature cosines, the beam cosine, and user view cosines, for
l = 0..nmom-1 and m = 0..nstr-1.

TPU-first design note: DISORT computes these per-mode inside the azimuth
loop.  Here the full (nmode, nmom, nangle) table is built once (host-side
numpy — it depends only on static angle sets) with Lam_l^m := 0 for l < m,
so every downstream sum over l is a dense masked contraction that batches
uniformly over the mode axis (no ragged per-mode shapes on device).
"""

from __future__ import annotations

import numpy as np


def legendre_assoc_norm(mu: np.ndarray, nmom: int, nmode: int) -> np.ndarray:
    """Table of normalized associated Legendre values.

    Args:
      mu: angles' cosines, any shape `(A,)` (float64 recommended).
      nmom: number of Legendre orders l = 0..nmom-1.
      nmode: number of azimuth modes m = 0..nmode-1.

    Returns:
      Array of shape (nmode, nmom, A) with entry [m, l, a] = Lam_l^m(mu_a),
      and exactly 0 for l < m.
    """
    mu = np.asarray(mu, dtype=np.float64)
    a = mu.shape[0]
    out = np.zeros((nmode, nmom, a), dtype=np.float64)
    somu2 = np.sqrt(np.maximum(0.0, 1.0 - mu * mu))
    for m in range(nmode):
        if m >= nmom:
            break
        # Seed: Lam_m^m = sqrt((2m-1)!! / (2m)!!) * (1-mu^2)^(m/2)
        c = 1.0
        for i in range(1, m + 1):
            c *= (2 * i - 1) / (2 * i)
        lam_prev = np.sqrt(c) * somu2**m   # l = m
        out[m, m] = lam_prev
        if m + 1 < nmom:
            # Lam_{m+1}^m = sqrt(2m+1) * mu * Lam_m^m
            lam = np.sqrt(2.0 * m + 1.0) * mu * lam_prev
            out[m, m + 1] = lam
            for l in range(m + 1, nmom - 1):
                # (upward recurrence in l)
                # sqrt((l+1-m)(l+1+m)) Lam_{l+1} = (2l+1) mu Lam_l
                #                                  - sqrt((l-m)(l+m)) Lam_{l-1}
                nxt = (
                    (2 * l + 1) * mu * lam - np.sqrt((l - m) * (l + m)) * lam_prev
                ) / np.sqrt((l + 1 - m) * (l + 1 + m))
                lam_prev, lam = lam, nxt
                out[m, l + 1] = lam
    return out


def legendre_poly(mu: np.ndarray, nmom: int) -> np.ndarray:
    """Plain Legendre polynomials P_l(mu), shape (nmom, A).  (m=0 slice.)"""
    return legendre_assoc_norm(mu, nmom, 1)[0]
