# Frozen copy of sbdart_tpu_torch/solver/bvp.py for the benchmark's reference: imports
# point into rtbench.reference; the float32 kernel routes taken out: every dtype takes the block-Thomas scan.
# Later changes do not edit it.
"""Boundary-value problem of the generic solver path (torch port of
sbdart_tpu/solver/bvp.py; disort.f:SETMTX + SOLVE0): stitch the per-layer
solutions into a column solution, for every azimuth mode.

The system is block-tridiagonal with 2N x 2N blocks over the layers
(N = nstr/2); per layer the unknowns are the amplitudes of the
down-decaying (a_l) and up-decaying (b_l) eigenmodes, with exponentials
in DISORT's boundary-anchored scaled form.  Block row l holds the
downward-intensity continuity at the top of layer l (the top boundary
condition for l = 0) and the upward-intensity continuity at its bottom
(the surface condition for l = L-1).

Per-layer tensors go to the lane layout [L, 2N(, 2N), B], B the flattened
(batch x mode) axis.  `solve_bvp` routes as the reference
(bvp.py:178-191): float32 runs the fused kernel the reference runs at the
shape (kernels/blocktri_rt_streamed.py:solve_bvp: B2, B5 or B6; the
kernel wrappers when `kernels`, else their plain versions), anything else
assembles the blocks (`assemble_blocks`) and runs `block_thomas_scan`.
Method "scan" takes the assembled-block route at every dtype, with B10
(kernels/blocktri.py) for the float32 elimination.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rtbench.reference.ops import lane
from rtbench.reference.ops.graph import const
from rtbench.reference.solver.eig import AngularTables, EigResult
from rtbench.reference.solver.sources import BeamSource, ThermalSource


class BvpSolution(NamedTuple):
    aa: torch.Tensor   # [..., m, L, N] down-decaying amplitudes
    bb: torch.Tensor   # [..., m, L, N] up-decaying amplitudes


class ParticularAtBounds(NamedTuple):
    """Particular-solution intensities at each layer's top and bottom."""
    top_up: torch.Tensor   # [..., m, L, N]
    top_dn: torch.Tensor
    bot_up: torch.Tensor
    bot_dn: torch.Tensor


def particular_at_bounds(beam: BeamSource, thermal: ThermalSource | None,
                         expbea, dtau, nmode: int) -> ParticularAtBounds:
    """expbea [..., L+1] = exp(-tau_l / mu0) at the boundaries; dtau
    [..., L]; the thermal source enters azimuth mode 0 only."""
    eb_top = expbea[..., None, :-1, None]     # [..., 1, L, 1]
    eb_bot = expbea[..., None, 1:, None]
    top_up = beam.zp * eb_top
    top_dn = beam.zm * eb_top
    bot_up = beam.zp * eb_bot
    bot_dn = beam.zm * eb_bot
    if thermal is not None:
        mode_mask = const((np.arange(nmode) == 0)[:, None, None],
                          top_up.dtype, top_up.device)     # 1 on mode 0
        d = dtau[..., None]
        top_up = top_up + mode_mask * thermal.y0p[..., None, :, :]
        top_dn = top_dn + mode_mask * thermal.y0m[..., None, :, :]
        bot_up = bot_up + mode_mask * (thermal.y0p
                                       + thermal.y1p * d)[..., None, :, :]
        bot_dn = bot_dn + mode_mask * (thermal.y0m
                                       + thermal.y1m * d)[..., None, :, :]
    return ParticularAtBounds(top_up, top_dn, bot_up, bot_dn)


def _to_scan_lane(x, ndim_mat: int):
    """[batch..., m, L, *mat] -> [L, *mat, B] with B = prod(batch) * m."""
    l_axis = x.ndim - ndim_mat - 1
    x = torch.movedim(x, l_axis, 0)           # [L, batch..., m, *mat]
    mat = tuple(x.shape[x.ndim - ndim_mat:])
    x = x.reshape((x.shape[0], -1) + mat)
    return torch.movedim(x, 1, -1)            # [L, *mat, B]


def _from_scan_lane(x, batch_shape: tuple):
    """[L, *mat, B] -> [batch..., m, L, *mat]."""
    x = torch.movedim(x, -1, 1)               # [L, B, *mat]
    x = x.reshape((x.shape[0],) + tuple(batch_shape) + tuple(x.shape[2:]))
    return torch.movedim(x, 0, len(batch_shape))


def _flat_bm(x, nmode: int):
    """[batch...] -> [B]: broadcast over the mode axis and flatten."""
    return x[..., None].expand(tuple(x.shape) + (nmode,)).reshape(-1)


def solve_bvp(eig: EigResult, part: ParticularAtBounds, dtau, surf_refl,
              fisot, top_emission, surf_emission, beam_refl_src,
              tab: AngularTables, *, kernels: bool = True,
              method: str = "auto") -> BvpSolution:
    """Assemble and solve the block-tridiagonal BVP for all azimuth modes.

    dtau [..., L] (delta-M scaled); surf_refl [..., m, N, N], the surface
    reflection operator (Lambertian: 2 albedo in mode 0; BRDF: R_m);
    fisot, top_emission [...]; surf_emission [..., N]; beam_refl_src
    [..., m, N], the reflected direct beam.  `method` "auto" or "scan"
    (module doc); `kernels` picks the float32 kernel wrappers over their
    plain versions."""
    dtype, device = dtau.dtype, dtau.device
    n = len(tab.mu)
    nmode = eig.kk.shape[-3]
    batch_shape = tuple(eig.kk.shape[:-3]) + (nmode,)
    w = const(tab.w, dtype, device)
    mu = const(tab.mu, dtype, device)
    wmu = (w * mu)[:, None]                        # [N, 1] column scale

    ee_std = torch.exp(-eig.kk * dtau[..., None, :, None])   # [..., m, L, N]
    gp = _to_scan_lane(eig.gp, 2)
    gm = _to_scan_lane(eig.gm, 2)
    ee = _to_scan_lane(ee_std, 1)
    p_tu = _to_scan_lane(part.top_up, 1)
    p_td = _to_scan_lane(part.top_dn, 1)
    p_bu = _to_scan_lane(part.bot_up, 1)
    p_bd = _to_scan_lane(part.bot_dn, 1)

    srefl = lane.to_lane(surf_refl)[0]             # [N, N, B]
    bref = lane.to_lane(beam_refl_src, 1)[0]       # [N, B]
    mode0 = const(np.arange(nmode) == 0, dtype, device).expand(
        batch_shape).reshape(-1)                   # [B] 1 on azimuth mode 0
    iso = (_flat_bm(fisot, nmode) + _flat_bm(top_emission, nmode)) * mode0
    ones_m = torch.ones((nmode, 1), dtype=dtype, device=device)
    semis = (lane.to_lane(surf_emission[..., None, :] * ones_m, 1)[0]
             * mode0[None, :])                     # [N, B]
    refl_op = srefl * wmu[None]                    # R[i,k] w_k mu_k

    # ---- right-hand side --------------------------------------------------
    r_top0 = iso[None, :] - p_td[0]
    r_topl = p_bd[:-1] - p_td[1:]
    r_top = torch.cat([r_top0[None], r_topl], dim=0)           # [L, N, B]
    r_botl = p_tu[1:] - p_bu[:-1]
    refl_part = lane.lmatvec(refl_op, p_bd[-1])
    r_botL = semis + bref + refl_part - p_bu[-1]
    r_bot = torch.cat([r_botl, r_botL[None]], dim=0)
    rhs = torch.cat([r_top, r_bot], dim=1)                     # [L, 2N, B]

    xs = block_thomas_scan(*assemble_blocks(gp, gm, ee, refl_op), rhs)
    x = _from_scan_lane(xs, batch_shape)                       # [..., m, L, 2N]
    return BvpSolution(x[..., :n], x[..., n:])


def assemble_blocks(gp, gm, ee, refl_op):
    """The block-tridiagonal operator (SETMTX): gp/gm [L, N, N, B], ee
    [L, N, B], refl_op [N, N, B] (R[i,k] w_k mu_k) -> (diag, lower, upper)
    each [L, 2N, 2N, B]."""
    e_col = ee[:, None, :, :]
    d_top = torch.cat([gm, gp * e_col], dim=2)                 # [L, N, 2N, B]
    d_bot = torch.cat([gp * e_col, gm], dim=2)
    # the surface reflection on the last layer's bottom rows: row i gains
    # -sum_k w_k mu_k R_m[i,k] (downward homogeneous solution)_kj
    refl_a = lane.lmatmul(refl_op, gm[-1] * e_col[-1])
    refl_b = lane.lmatmul(refl_op, gp[-1])
    refl = torch.cat([refl_a, refl_b], dim=1)                  # [N, 2N, B]
    d_bot = torch.cat([d_bot[:-1], (d_bot[-1] - refl)[None]])
    diag = torch.cat([d_top, d_bot], dim=1)                    # [L, 2N, 2N, B]

    # lower blocks (couple x_{l-1}): top rows, l >= 1
    low_top = torch.cat([gm * e_col, gp], dim=2)               # layer l-1
    lower = torch.cat([-low_top, torch.zeros_like(low_top)], dim=1)
    lower = torch.cat([torch.zeros_like(lower[:1]), lower[:-1]], dim=0)
    # upper blocks (couple x_{l+1}): bottom rows, l <= L-2
    up_bot = torch.cat([gp, gm * e_col], dim=2)                # layer l+1
    upper = torch.cat([torch.zeros_like(up_bot), -up_bot], dim=1)
    upper = torch.cat([upper[1:], torch.zeros_like(upper[:1])], dim=0)
    return diag, lower, upper


def block_thomas_scan(diag, lower, upper, rhs):
    """Block-Thomas over the layers with the lane solver (the reference's
    lax.scan fallback, ops/lane.py:lsolve): diag/lower/upper [L, m, m, B],
    rhs [L, m, B] -> xs [L, m, B]."""
    m2 = diag.shape[1]
    w_prev = diag[0] * 0.0
    y_prev = rhs[0] * 0.0
    ws, ys = [], []
    for d_l, a_l, u_l, r_l in zip(diag, lower, upper, rhs):
        dt = d_l - lane.lmatmul(a_l, w_prev)
        rt = r_l - lane.lmatvec(a_l, y_prev)
        sol = lane.lsolve(dt, torch.cat([u_l, rt[:, None, :]], dim=1))
        w_prev, y_prev = sol[:, :m2], sol[:, m2]
        ws.append(w_prev)
        ys.append(y_prev)
    xs = [y_prev]
    for w_l, y_l in zip(reversed(ws[:-1]), reversed(ys[:-1])):
        xs.append(y_l - lane.lmatvec(w_l, xs[-1]))
    return torch.stack(xs[::-1], dim=0)


class BoundaryIntensities(NamedTuple):
    """Quadrature-angle intensities at the L+1 layer boundaries."""
    up: torch.Tensor   # [..., m, L+1, N]  I(+mu_i)
    dn: torch.Tensor   # [..., m, L+1, N]  I(-mu_i)


def intensity_at_boundaries(eig: EigResult, sol: BvpSolution,
                            part: ParticularAtBounds,
                            dtau) -> BoundaryIntensities:
    """The full solution at every layer boundary (quadrature angles)."""
    nmode = eig.kk.shape[-3]
    batch_shape = tuple(eig.kk.shape[:-3]) + (nmode,)
    ee_std = torch.exp(-eig.kk * dtau[..., None, :, None])
    gp = _to_scan_lane(eig.gp, 2)                # [L, N, N, B]
    gm = _to_scan_lane(eig.gm, 2)
    e_col = _to_scan_lane(ee_std, 1)[:, None, :, :]
    a = _to_scan_lane(sol.aa, 1)
    b = _to_scan_lane(sol.bb, 1)

    # at layer tops (t' = 0): hom = G a + (G~ e) b; at bottoms (t' = dtau):
    # hom = (G e) a + G~ b
    top_up = lane.lmatvec(gp, a) + lane.lmatvec(gm * e_col, b)
    top_dn = lane.lmatvec(gm, a) + lane.lmatvec(gp * e_col, b)
    bot_up = lane.lmatvec(gp * e_col, a) + lane.lmatvec(gm, b)
    bot_dn = lane.lmatvec(gm * e_col, a) + lane.lmatvec(gp, b)

    p_tu = _to_scan_lane(part.top_up, 1)
    p_td = _to_scan_lane(part.top_dn, 1)
    p_bu = _to_scan_lane(part.bot_up, 1)
    p_bd = _to_scan_lane(part.bot_dn, 1)
    up = torch.cat([top_up + p_tu, (bot_up + p_bu)[-1:]], dim=0)
    dn = torch.cat([top_dn + p_td, (bot_dn + p_bd)[-1:]], dim=0)
    return BoundaryIntensities(_from_scan_lane(up, batch_shape),
                               _from_scan_lane(dn, batch_shape))
