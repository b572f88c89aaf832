# Frozen copy of sbdart_tpu_torch/solver/sources.py for the benchmark's reference: imports
# point into rtbench.reference.
# Later changes do not edit it.
"""Particular solutions of the discrete-ordinates RTE (torch port of
sbdart_tpu/solver/sources.py; disort.f:UPBEAM and UPISOT), and the
normalized Legendre functions at a traced beam cosine.

Within layer l (local coordinate t' in [0, dtau_l]):

    beam:    I_p(t', u) = Z(u) exp(-(tau_top_l + t') / mu0)
    thermal: I_t(t', u) = Y0(u) + Y1(u) t'        (azimuth mode 0 only)

with u over the 2N quadrature directions [+mu_1..+mu_N, -mu_1..-mu_N].
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from rtbench.reference.constants import slope_tau_floor
from rtbench.reference.ops import lane
from rtbench.reference.ops.graph import const as device_const


def _ylm_at(mu0: torch.Tensor, nmode: int, nmom: int) -> torch.Tensor:
    """Normalized associated Legendre Lam_l^m at the cosines `mu0`, by the
    recurrence of solver/legendre.py.  Returns [..., nmode, nmom]."""
    dtype, device = mu0.dtype, mu0.device

    def const(v):
        return device_const(v, dtype, device)

    somu2 = torch.sqrt(torch.clamp(1.0 - mu0 * mu0, 0.0, 1.0))
    rows = []
    for m in range(nmode):
        vals = [torch.zeros_like(mu0)] * m
        c = 1.0
        for i in range(1, m + 1):
            c *= (2 * i - 1) / (2 * i)
        lam_prev = torch.sqrt(const(c)) * somu2**m
        if m < nmom:
            vals.append(lam_prev)
        if m + 1 < nmom:
            lam = torch.sqrt(const(2.0 * m + 1.0)) * mu0 * lam_prev
            vals.append(lam)
            for l in range(m + 1, nmom - 1):
                nxt = (
                    (2 * l + 1) * mu0 * lam
                    - torch.sqrt(const(float((l - m) * (l + m)))) * lam_prev
                ) / torch.sqrt(const(float((l + 1 - m) * (l + 1 + m))))
                lam_prev, lam = lam, nxt
                vals.append(lam)
        rows.append(torch.stack(vals[:nmom], dim=-1))
    return torch.stack(rows, dim=-2)


def full_scatter_matrix(cpp, cpm, w) -> torch.Tensor:
    """The full 2N x 2N quadrature scattering operator [[A, B], [B, A]],
    A = C^pp W, B = C^pm W, acting on [I(+mu), I(-mu)]."""
    a = cpp * w
    b = cpm * w
    return torch.cat([torch.cat([a, b], dim=-1), torch.cat([b, a], dim=-1)],
                     dim=-2)


class BeamSource(NamedTuple):
    zp: torch.Tensor    # [..., nmode, L, N]  Z at +mu_i
    zm: torch.Tensor    # [..., nmode, L, N]  Z at -mu_i


def beam_particular(cpp, cpm, ssalb, gl, fbeam, umu0, tab) -> BeamSource:
    """The beam particular solution per (batch, mode, layer)
    (sources.py:47-131): cpp/cpm [..., m, L, N, N] from solve_eigen; ssalb
    [..., L] and gl [..., L, nstr] delta-M scaled; fbeam, umu0 [...] (no
    beam: a safe mu0 and a zero right-hand side).  The 2N system splits by
    the +- symmetry into the reduced N x N solve

        [(a+b)(a-b) - I/mu0^2] S = (a+b) r1 - r2/mu0,  D = (r1 - (a-b) S) mu0

    with Z+- = (S +- D) / 2, in lane layout (ops/lane.py:lsolve)."""
    dtype, device = gl.dtype, gl.device

    def t(x):
        return device_const(x, dtype, device)

    n = len(tab.mu)
    nmode = tab.ylm.shape[0]
    mu, w = t(tab.mu), t(tab.w)
    ylm = t(tab.ylm)                            # [m, nstr, N]
    parity = t(tab.parity)                      # [m, nstr]

    has_beam = fbeam > 0.0
    mu0 = torch.where(has_beam, torch.abs(umu0), 0.5)
    # X0(u_i) = (w0 F0 (2 - delta_m0) / 4pi) sum_l (2l+1) g_l
    #            Lam_l^m(u_i) Lam_l^m(-mu0)
    ylm0_down = _ylm_at(mu0, nmode, ylm.shape[1]) * parity   # [..., m, nstr]
    mfac = t(np.where(np.arange(nmode) == 0, 1.0, 2.0))      # 2 - delta_m0
    c = 0.5 * ssalb[..., None] * t(tab.twol1) * gl           # [..., L, nstr]
    x0p = torch.einsum("...Ll,...ml,mli->...mLi", c, ylm0_down, ylm)
    x0m = torch.einsum("...Ll,...ml,ml,mli->...mLi", c, ylm0_down, parity,
                       ylm)
    scale = (torch.where(has_beam, fbeam, 0.0)[..., None, None, None]
             * mfac[:, None, None] / (2.0 * math.pi))
    x0p = x0p * scale
    x0m = x0m * scale

    cppl, batch_shape = lane.to_lane(cpp)       # [N, N, B]
    cpml, _ = lane.to_lane(cpm)
    eye = torch.eye(n, dtype=dtype, device=device)[..., None]
    inv_mu_i = (1.0 / mu)[:, None, None]
    w_j = w[None, :, None]
    amb = inv_mu_i * (eye - (cppl + cpml) * w_j)          # alpha - beta
    apb = inv_mu_i * (eye - (cppl - cpml) * w_j)          # alpha + beta

    nlyr = cpp.shape[-3]
    mu0_flat = mu0[..., None, None].expand(
        tuple(mu0.shape) + (nmode, nlyr)).reshape(-1)     # [B]
    inv_mu0 = 1.0 / mu0_flat
    r1 = lane.to_lane((x0p + x0m) / mu, 1)[0]             # [N, B]
    r2 = lane.to_lane((x0p - x0m) / mu, 1)[0]
    mat = lane.lmatmul(apb, amb) - eye * inv_mu0**2
    rhs = lane.lmatvec(apb, r1) - r2 * inv_mu0
    s = lane.lsolve(mat, rhs[:, None, :])[:, 0]
    d = (r1 - lane.lmatvec(amb, s)) * mu0_flat
    return BeamSource(lane.from_lane(0.5 * (s + d), batch_shape),
                      lane.from_lane(0.5 * (s - d), batch_shape))


class ThermalSource(NamedTuple):
    y0p: torch.Tensor   # [..., L, N]  Y0 at +mu_i   (mode 0 only)
    y0m: torch.Tensor   # [..., L, N]
    y1p: torch.Tensor   # [..., L, N]
    y1m: torch.Tensor   # [..., L, N]
    b_top: torch.Tensor  # [..., L] Planck at layer tops
    b_bot: torch.Tensor  # [..., L] Planck at layer bottoms


def thermal_particular(cpp0, cpm0, ssalb, dtau, b_level, tab) -> ThermalSource:
    """Thermal (Planck) particular solution, azimuth mode 0.

    cpp0/cpm0: mode-0 scattering matrices [..., L, N, N]; ssalb, dtau
    [..., L] (delta-M scaled); b_level: band-integrated Planck radiance at
    the L+1 levels [..., L+1]; tab: the AngularTables.  Reduced N x N
    solves via the +- symmetry (the emission source is up/down symmetric):

        Y1+ = Y1- = S1/2,        (alpha-beta) S1 = 2 (1-w0) b1 / mu
        Y0+- = (S0 +- D0)/2,     (alpha-beta) S0 = 2 (1-w0) Btop / mu
                                 (alpha+beta) D0 = S1
    """
    dtype, device = cpp0.dtype, cpp0.device
    n = len(tab.mu)
    mu = device_const(tab.mu, dtype, device)
    w = device_const(tab.w, dtype, device)
    b_top = b_level[..., :-1]
    b_bot = b_level[..., 1:]
    b1 = (b_bot - b_top) / torch.clamp_min(dtau, slope_tau_floor(dtype))

    cppl, batch_shape = lane.to_lane(cpp0)       # [N, N, B], B = batch x L
    cpml, _ = lane.to_lane(cpm0)
    eye = torch.eye(n, dtype=dtype, device=device)[..., None]
    inv_mu_i = (1.0 / mu)[:, None, None]
    w_j = w[None, :, None]
    amb = inv_mu_i * (eye - (cppl + cpml) * w_j)
    apb = inv_mu_i * (eye - (cppl - cpml) * w_j)
    emis = (1.0 - ssalb)[..., None]              # [..., L, 1]
    ones_mu = 1.0 / mu                           # [N] (the 1/mu weighting)
    rhs1 = lane.to_lane(2.0 * emis * b1[..., None] * ones_mu, 1)[0]
    rhs0 = lane.to_lane(2.0 * emis * b_top[..., None] * ones_mu, 1)[0]
    both = lane.lsolve(amb, torch.stack([rhs1, rhs0], dim=1))   # [N, 2, B]
    s1 = both[:, 0]
    s0 = both[:, 1]
    d0 = lane.lsolve(apb, s1[:, None, :])[:, 0]
    y1p = lane.from_lane(0.5 * s1, batch_shape)
    y0p = lane.from_lane(0.5 * (s0 + d0), batch_shape)
    y0m = lane.from_lane(0.5 * (s0 - d0), batch_shape)
    return ThermalSource(y0p, y0m, y1p, y1p, b_top, b_bot)

