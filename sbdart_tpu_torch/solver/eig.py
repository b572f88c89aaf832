"""Static angular tables of the discrete-ordinates eigenproblem (NumPy).

The eigensolves themselves are fused into the front-end kernels
(sbdart_tpu_torch/kernels/eig_n2.py, eig_n2_scatter.py, eig_beam.py);
this module carries only the trace-time tables of
sbdart_tpu/solver/eig.py:41-56.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from sbdart_tpu_torch.solver.legendre import legendre_assoc_norm
from sbdart_tpu_torch.solver.quadrature import double_gauss


class AngularTables(NamedTuple):
    """Static angular discretization tables."""
    mu: np.ndarray        # [N] quadrature cosines (> 0)
    w: np.ndarray         # [N] quadrature weights
    ylm: np.ndarray       # [nmode, nstr, N]  Lam_l^m(mu_i), 0 for l < m
    parity: np.ndarray    # [nmode, nstr]     (-1)^(l-m)
    twol1: np.ndarray     # [nstr]            (2l+1)


def angular_tables(nstr: int, nmode: int) -> AngularTables:
    mu, w = double_gauss(nstr)
    ylm = legendre_assoc_norm(mu, nstr, nmode)
    l = np.arange(nstr)
    m = np.arange(nmode)[:, None]
    parity = np.where(l[None, :] >= m, (-1.0) ** (l[None, :] - m), 0.0)
    return AngularTables(mu, w, ylm, parity, 2.0 * l + 1.0)
