"""Per-layer homogeneous solutions of the discrete-ordinates RTE (torch port
of sbdart_tpu/solver/eig.py; disort.f:SOLEIG + ASYMTX).

For azimuth mode m the homogeneous solutions I = G(+-mu_i) exp(-+ k tau)
come from the reduced (N x N, N = nstr/2) eigenproblem

    k^2 X = (alpha + beta)(alpha - beta) X
    alpha -+ beta = M^-1 (I - (C^pp +- C^pm) W)

made symmetric by the congruence P = diag(sqrt(mu w)): with the Cholesky
factor S- = L L^T, L^T S+ L is symmetric with eigenvalues k^2.

Routes of `solve_eigen` (the reference's, solver/eig.py:104-119, with the
float32 kernel route where the reference is on its TPU):
  * "pallas": B9 (kernels/eig_chain.py) for float32 with N even and <= 8;
  * "lane": the lane-layout chain (ops/lane.py, 6 sorted Jacobi sweeps)
    for other float32 solves with N <= 16;
  * "xla": batch-major torch.linalg (eigh, Cholesky, a general solve of
    the triangular system) otherwise and for float64.

All arrays carry leading batch dims [..., nmode, L]; matrices [..., N, N].
The static tables (`angular_tables`) are NumPy.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from sbdart_tpu_torch.ops import lane
from sbdart_tpu_torch.ops.graph import const
from sbdart_tpu_torch.ops.batched_linalg import (
    cholesky_small,
    eigh_small,
    gauss_solve,
)
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


class EigResult(NamedTuple):
    kk: torch.Tensor   # [..., nmode, L, N]    eigenvalues k_j > 0
    gp: torch.Tensor   # [..., nmode, L, N, N] G at +mu_i (row i), mode j
    gm: torch.Tensor   # [..., nmode, L, N, N] G at -mu_i
    cpp: torch.Tensor | None  # [..., nmode, L, N, N] same-hemisphere C^pp
    cpm: torch.Tensor | None  # [..., nmode, L, N, N] cross-hemisphere C^pm


def _t(x, like):
    return const(x, like.dtype, like.device)


def scattering_matrices(ssalb, gl, tab: AngularTables):
    """C^pp, C^pm [..., nmode, L, N, N]: the hemispherically folded
    scattering matrices per mode, from the delta-M-scaled ssalb [..., L]
    and moments gl [..., L, nstr]."""
    ylm = _t(tab.ylm, gl)                      # [M, nstr, N]
    parity = _t(tab.parity, gl)                # [M, nstr]
    c = 0.5 * ssalb[..., None] * _t(tab.twol1, gl) * gl
    c = c[..., None, :, :]                     # add the mode axis
    cpp = torch.einsum("...mLl,mli,mlj->...mLij", c, ylm, ylm)
    cpm = torch.einsum("...mLl,ml,mli,mlj->...mLij", c, parity, ylm, ylm)
    return cpp, cpm


def eig_route(n: int, dtype: torch.dtype) -> str:
    """solve_eigen's "auto" choice (the reference's, solver/eig.py:104-119,
    on its TPU for float32): "pallas" (B9) for float32 with N even and
    <= 8, "lane" for other float32 with N <= 16, "xla" otherwise."""
    if dtype == torch.float32 and n <= 8 and n % 2 == 0:
        return "pallas"
    if dtype == torch.float32 and n <= 16:
        return "lane"
    return "xla"


def solve_eigen(ssalb, gl, tab: AngularTables,
                eig_method: str = "auto") -> EigResult:
    """The per-layer homogeneous problem for all azimuth modes: ssalb
    [..., L] (delta-M scaled, dithered < 1), gl [..., L, nstr].  Method
    "auto" (`eig_route`), "pallas" (B9's wrapper), "lane" or "xla"."""
    from sbdart_tpu_torch.kernels.eig_chain import eig_chain_lane

    n = len(tab.mu)
    cpp, cpm = scattering_matrices(ssalb, gl, tab)
    if eig_method == "auto":
        eig_method = eig_route(n, gl.dtype)
    if eig_method == "pallas":
        cppl, batch_shape = lane.to_lane(cpp)
        cpml, _ = lane.to_lane(cpm)
        kk, gp, gm = eig_chain_lane(cppl, cpml, tab.mu, tab.w)
        return EigResult(lane.from_lane(kk, batch_shape),
                         lane.from_lane(gp, batch_shape),
                         lane.from_lane(gm, batch_shape), cpp, cpm)
    mu = _t(tab.mu, gl)
    w = _t(tab.w, gl)
    if eig_method == "lane":
        return EigResult(*_eigen_chain_lane(cpp, cpm, mu, w), cpp, cpm)

    eye = torch.eye(n, dtype=gl.dtype, device=gl.device)
    inv_mu = (1.0 / mu)[:, None]               # row scaling M^-1
    amb = inv_mu * (eye - (cpp + cpm) * w)     # [..., m, L, N, N]
    apb = inv_mu * (eye - (cpp - cpm) * w)
    p = torch.sqrt(mu * w)
    s_minus = p[:, None] * amb / p[None, :]
    s_plus = p[:, None] * apb / p[None, :]
    s_minus = 0.5 * (s_minus + s_minus.transpose(-1, -2))
    s_plus = 0.5 * (s_plus + s_plus.transpose(-1, -2))

    # a few-eps ridge keeps the Cholesky of near-conservative layers
    # (cond ~ 1/(1 - w0)) full-rank, in the working dtype's eps
    eps = torch.finfo(gl.dtype).eps
    trace = torch.diagonal(s_minus, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    s_minus = s_minus + (8.0 * eps / n) * trace * eye
    l = cholesky_small(s_minus, method="xla")        # S- = L L^T
    lt_sp_l = l.transpose(-1, -2) @ s_plus @ l
    lt_sp_l = 0.5 * (lt_sp_l + lt_sp_l.transpose(-1, -2))
    k2, v = eigh_small(lt_sp_l, method="xla")
    kk = torch.sqrt(torch.clamp_min(k2, 1e-30))      # [..., m, L, N]

    # X = P^-1 L^-T V by a general solve, as the reference's gauss_solve
    # (xla); Y = -(alpha - beta) X / k
    z = gauss_solve(l.transpose(-1, -2), v, method="xla")
    x = z / p[:, None]
    y = -(amb @ x) / kk[..., None, :]
    return EigResult(kk, 0.5 * (x + y), 0.5 * (x - y), cpp, cpm)


def scattering_matrices_lane_mode0(ssalb, gl, tab: AngularTables):
    """cppl/cpml [N, N, B] and c_lane [nstr, B] of azimuth mode 0 directly
    in lane layout (a contraction over the moment index), and the batch
    shape (solver/eig.py:172-198)."""
    n = len(tab.mu)
    nstr = tab.ylm.shape[1]
    c = 0.5 * ssalb[..., None] * _t(tab.twol1, gl) * gl     # [..., L, nstr]
    c_lane, batch_shape = lane.to_lane(c, 1)                # [nstr, B]
    ylm0 = np.asarray(tab.ylm[0], np.float64)               # [nstr, N]
    par0 = np.asarray(tab.parity[0], np.float64)            # [nstr]
    a_pp = (ylm0[:, :, None] * ylm0[:, None, :]).reshape(nstr, n * n)
    a_pm = a_pp * par0[:, None]
    b = c_lane.shape[-1]
    cppl = torch.einsum("lk,lB->kB", _t(a_pp, gl), c_lane).reshape(n, n, b)
    cpml = torch.einsum("lk,lB->kB", _t(a_pm, gl), c_lane).reshape(n, n, b)
    return cppl, cpml, c_lane, batch_shape


def solve_eigen_beam_fused(ssalb, gl, fbeam, umu0, tab: AngularTables, *,
                           need_cppcpm: bool = False):
    """The flux-mode (nmode = 1) front end of the generic path
    (solver/eig.py:201-276): the mode-0 scattering matrices and the
    reduced beam right-hand side in lane layout, then the eigen chain with
    the beam solve on the flat lane axis (kernels/eig_beam.py:
    eig_beam_chain_lane: B8 at N = 2, B4 at N = 4, 6, 8).  Returns
    (EigResult, BeamSource); EigResult.cpp/.cpm are kept only when
    `need_cppcpm` (the thermal path wants them)."""
    from sbdart_tpu_torch.kernels.eig_beam import eig_beam_chain_lane
    from sbdart_tpu_torch.solver.sources import BeamSource, _ylm_at

    nstr = tab.ylm.shape[1]
    assert tab.ylm.shape[0] == 1, "the fused front end is flux-mode only"
    nlyr = gl.shape[-2]
    cppl, cpml, c_lane, _ = scattering_matrices_lane_mode0(ssalb, gl, tab)

    # ---- beam RHS in lane space ------------------------------------------
    has_beam = fbeam > 0.0
    mu0 = torch.where(has_beam, torch.abs(umu0), 0.5)
    bshape = tuple(mu0.shape)
    mu0_l = mu0[..., None].expand(bshape + (nlyr,)).reshape(1, -1)
    scale = torch.where(has_beam, fbeam, 0.0) / (2.0 * math.pi)
    scale_l = scale[..., None].expand(bshape + (nlyr,)).reshape(-1)

    par0 = _t(tab.parity[0], gl)
    y0d = _ylm_at(mu0, 1, nstr)[..., 0, :] * par0          # Lam_l(-mu0)
    y0d_lane = lane.to_lane(
        y0d[..., None, :].expand(bshape + (nlyr, nstr)), 1)[0]  # [nstr, B]
    prod = c_lane * y0d_lane
    ylm_mat = _t(tab.ylm[0].T, gl)                          # [N, nstr]
    x0p = (ylm_mat @ prod) * scale_l[None, :]               # [N, B]
    x0m = ((ylm_mat * par0[None, :]) @ prod) * scale_l[None, :]
    inv_mu_col = _t(1.0 / tab.mu, gl)[:, None]
    r1 = (x0p + x0m) * inv_mu_col
    r2 = (x0p - x0m) * inv_mu_col

    kk_l, gp_l, gm_l, zp_l, zm_l = eig_beam_chain_lane(
        cppl, cpml, r1, r2, mu0_l, tab)
    # unflatten with the (size-1) mode axis of the solver's convention
    batch_shape = tuple(ssalb.shape[:-1]) + (1, nlyr)
    kk, gp, gm, zp, zm = (lane.from_lane(x, batch_shape)
                          for x in (kk_l, gp_l, gm_l, zp_l, zm_l))
    cpp = cpm = None
    if need_cppcpm:
        cpp = lane.from_lane(cppl, batch_shape)
        cpm = lane.from_lane(cpml, batch_shape)
    return EigResult(kk, gp, gm, cpp, cpm), BeamSource(zp, zm)


def _eigen_chain_lane(cpp, cpm, mu, w):
    """The SOLEIG chain in lane layout (matrix dims leading, batch minor;
    solver/eig.py:279-322): one relayout in, three out."""
    n = mu.shape[0]
    dtype = cpp.dtype
    cppl, batch_shape = lane.to_lane(cpp)      # [N, N, B]
    cpml, _ = lane.to_lane(cpm)

    eye = torch.eye(n, dtype=dtype, device=cpp.device)[..., None]
    inv_mu_i = (1.0 / mu)[:, None, None]
    w_j = w[None, :, None]
    amb = inv_mu_i * (eye - (cppl + cpml) * w_j)
    apb = inv_mu_i * (eye - (cppl - cpml) * w_j)

    p = torch.sqrt(mu * w)
    p_i = p[:, None, None]
    p_j = p[None, :, None]
    s_minus = p_i * amb / p_j
    s_plus = p_i * apb / p_j
    s_minus = 0.5 * (s_minus + lane.ltranspose(s_minus))
    s_plus = 0.5 * (s_plus + lane.ltranspose(s_plus))

    eps = torch.finfo(dtype).eps
    trace = torch.sum(s_minus * eye, dim=(0, 1))          # [B]
    s_minus = s_minus + (8.0 * eps / n) * trace * eye
    l = lane.lcholesky(s_minus)
    lt = lane.ltranspose(l)
    lt_sp_l = lane.lmatmul(lane.lmatmul(lt, s_plus), l)
    lt_sp_l = 0.5 * (lt_sp_l + lane.ltranspose(lt_sp_l))
    k2, v = lane.leigh(lt_sp_l)                          # [N, B], [N, N, B]
    kk = torch.sqrt(torch.clamp_min(k2, 1e-30))

    z = lane.lsolve_upper_tri(lt, v)
    x = z / p[:, None, None]
    y = -lane.lmatmul(amb, x) / kk[None, :, :]
    return (lane.from_lane(kk, batch_shape),
            lane.from_lane(0.5 * (x + y), batch_shape),
            lane.from_lane(0.5 * (x - y), batch_shape))
