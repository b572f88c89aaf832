"""Lane-resident flux path at nstr=4 (torch port of
sbdart_tpu/solver/fluxlane.py, branch `fused_head`, planck off).

The whole flux-only (azimuth mode 0) solve runs in one column-minor
layout [L, *, B]: the B1 front-end kernel (kernels/eig_n2.py) takes the
raw optics and emits every per-layer quantity, the B2 kernel
(kernels/blocktri_n2.py) solves the boundary-value problem, and plain
torch glue does the rest: tau cumsum, beam exponentials, the particular
solution at layer bounds, the Lambertian surface operators, the BVP
right-hand side, boundary intensities, fluxes, uavg and dfdt.

Reference map: the DISORT call chain SOLEIG+UPBEAM+SETMTX+SOLVE0+FLUXES
(disort.f) as two fused kernels plus glue.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from sbdart_tpu_torch.convert import tables_to_torch
from sbdart_tpu_torch.kernels.blocktri_n2 import (
    block_thomas_rt_n2,
    block_thomas_rt_n2_plain,
)
from sbdart_tpu_torch.kernels.eig_n2 import (
    eig_beam_deltam_scatter_n2,
    eig_beam_deltam_scatter_n2_plain,
)
from sbdart_tpu_torch.solver.disort import RteOutputs
from sbdart_tpu_torch.solver.eig import AngularTables, angular_tables

NSTR = 4
N = NSTR // 2


def to_scan(x, nl_axis_from_end=1):
    """[batch..., L] -> [L, B] (or [batch..., L, k] -> [L, k, B])."""
    if nl_axis_from_end == 1:
        x = torch.movedim(x, -1, 0)               # [L, batch...]
        return x.reshape(x.shape[0], -1)
    x = torch.movedim(x, -2, 0)                   # [L, batch..., k]
    x = x.reshape(x.shape[0], -1, x.shape[-1])    # [L, B, k]
    return torch.movedim(x, -1, 1)                # [L, k, B]


class FrontEnd(NamedTuple):
    """Per-layer quantities in scan layout, from the B1 front end."""
    tab: AngularTables    # numpy tables (nstr=4, one mode)
    w: torch.Tensor       # [N] quadrature weights
    wmu: torch.Tensor     # [N] w * mu
    kk: torch.Tensor      # [L, 2, B]
    gp: torch.Tensor      # [L, 2, 2, B]
    gm: torch.Tensor      # [L, 2, 2, B]
    zp: torch.Tensor      # [L, 2, B]
    zm: torch.Tensor      # [L, 2, B]
    ee: torch.Tensor      # [L, 2, B]
    eb: torch.Tensor      # [L+1, B] scaled-tau beam attenuation
    eb_u: torch.Tensor    # [L+1, B] unscaled-tau beam attenuation
    mu0: torch.Tensor     # [batch] beam cosine (dithered where no beam)
    has_beam: torch.Tensor  # [batch] bool


def front_operands(dtauc, ssalb_in, pmom, *, fbeam, umu0, deltam):
    """The B1 kernel's operands in scan layout, from batch-major inputs:
    (dtau [L, B], ssalb [L, B], pmom5 [L, 5, B], scale [1, B], mu0 [1, B]),
    and whether delta-M applies."""
    has_beam = fbeam > 0.0
    mu0_row = torch.where(has_beam, torch.abs(umu0), 0.5).reshape(1, -1)
    scale_row = (torch.where(has_beam, fbeam, 0.0) / (2.0 * math.pi)) \
        .reshape(1, -1)
    pm5 = pmom[..., :5]
    if pm5.shape[-1] < 5:
        pm5 = F.pad(pm5, (0, 5 - pm5.shape[-1]))
    ops = (to_scan(dtauc), to_scan(ssalb_in), to_scan(pm5, 2),
           scale_row, mu0_row)
    return ops, bool(deltam) and pmom.shape[-1] > NSTR


def front_end(dtauc, ssalb_in, pmom, *, fbeam, umu0, deltam, kernels):
    """Optics -> eigen/beam quantities (fluxlane.py:59-117).  Inputs are
    batch-major and already broadcast; `kernels` picks the B1 wrapper
    (CUDA kernel on CUDA tensors) over its plain version."""
    tab = angular_tables(NSTR, 1)
    tab_t = tables_to_torch(tab, device=dtauc.device, dtype=dtauc.dtype)
    ops, use_dm = front_operands(dtauc, ssalb_in, pmom, fbeam=fbeam,
                                 umu0=umu0, deltam=deltam)
    dtau_raw_scan, mu0_row = ops[0], ops[4]
    front = (eig_beam_deltam_scatter_n2 if kernels
             else eig_beam_deltam_scatter_n2_plain)
    kk, gp, gm, zp, zm, dtau_scan, ee = front(*ops, tab, use_deltam=use_dm)

    has_beam = fbeam > 0.0
    has_beam_row = has_beam.reshape(1, -1)
    zrow = torch.zeros_like(mu0_row)
    tau_s_scan = torch.cat([zrow, torch.cumsum(dtau_scan, dim=0)], dim=0)
    tau_u_scan = torch.cat([zrow, torch.cumsum(dtau_raw_scan, dim=0)], dim=0)
    eb = torch.where(has_beam_row, torch.exp(-tau_s_scan / mu0_row), 0.0)
    eb_u = torch.where(has_beam_row, torch.exp(-tau_u_scan / mu0_row), 0.0)
    return FrontEnd(tab, tab_t.w, tab_t.w * tab_t.mu, kk, gp, gm, zp, zm,
                    ee, eb, eb_u, mu0_row.reshape(has_beam.shape), has_beam)


class BvpSystem(NamedTuple):
    """Operands of the B2 solve plus the particular solution at bounds."""
    refl: torch.Tensor    # [2, 2, B] Lambertian operator R[i, k] w_k mu_k
    rhs: torch.Tensor     # [L, 4, B]
    p_tu: torch.Tensor    # [L, 2, B] particular solution, layer tops (+mu)
    p_td: torch.Tensor    # [L, 2, B]                      layer tops (-mu)
    p_bu: torch.Tensor    # [L, 2, B]                   layer bottoms (+mu)
    p_bd: torch.Tensor    # [L, 2, B]                   layer bottoms (-mu)


def bvp_system(fe: FrontEnd, *, fbeam, fisot, albedo) -> BvpSystem:
    """Particular solution at layer bounds, Lambertian surface operators
    and the BVP right-hand side (fluxlane.py:190-274 without planck)."""
    eb = fe.eb
    p_tu = fe.zp * eb[:-1, None, :]
    p_td = fe.zm * eb[:-1, None, :]
    p_bu = fe.zp * eb[1:, None, :]
    p_bd = fe.zm * eb[1:, None, :]

    dtype, device = eb.dtype, eb.device
    alb_flat = albedo.reshape(-1)                        # [Bc]
    beam_flux_flat = (
        fe.mu0.reshape(-1) * torch.where(fe.has_beam, fbeam, 0.0).reshape(-1)
        * eb[-1]
    )                                                    # [Bc]
    refl = (
        2.0 * alb_flat[None, None, :] * fe.wmu[None, :, None]
        * torch.ones((N, 1, 1), dtype=dtype, device=device)
    )                                                    # [N, N, Bc]
    bref = ((alb_flat / math.pi) * beam_flux_flat)[None, :].expand(N, -1)
    iso = fisot.reshape(-1)

    r_top0 = iso[None, :] - p_td[0]
    r_topl = p_bd[:-1] - p_td[1:]
    r_top = torch.cat([r_top0[None], r_topl], dim=0)
    r_botl = p_tu[1:] - p_bu[:-1]
    refl_part = torch.sum(refl * p_bd[-1][None, :, :], dim=1)
    r_botL = bref + refl_part - p_bu[-1]
    r_bot = torch.cat([r_botl, r_botL[None]], dim=0)
    rhs = torch.cat([r_top, r_bot], dim=1)               # [L, 2N, Bc]
    return BvpSystem(refl, rhs, p_tu, p_td, p_bu, p_bd)


def solve_rte_flux_lane(dtauc, ssalb_in, pmom, *, fbeam, umu0, fisot,
                        albedo, deltam, kernels=True) -> RteOutputs:
    """Flux-mode nstr=4 solve, lane-resident.  Inputs batch-major as in
    solve_rte (already broadcast, one dtype and device); returns
    RteOutputs with uu=None."""
    nlyr = dtauc.shape[-1]
    batch = tuple(dtauc.shape[:-1])
    fe = front_end(dtauc, ssalb_in, pmom, fbeam=fbeam, umu0=umu0,
                   deltam=deltam, kernels=kernels)
    sysm = bvp_system(fe, fbeam=fbeam, fisot=fisot, albedo=albedo)
    solve = block_thomas_rt_n2 if kernels else block_thomas_rt_n2_plain
    xs = solve(fe.gp, fe.gm, fe.ee, sysm.refl, sysm.rhs)
    a = xs[:, :N]                                        # [L, N, Bc]
    b = xs[:, N:]

    # ---- boundary intensities + fluxes (FLUXES) --------------------------
    gp, gm = fe.gp, fe.gm
    e_col = fe.ee[:, None, :, :]

    def mv(m_, v_):
        return torch.sum(m_ * v_[:, None, :, :], dim=2)

    top_up = mv(gp, a) + mv(gm * e_col, b)
    top_dn = mv(gm, a) + mv(gp * e_col, b)
    bot_up = mv(gp * e_col, a) + mv(gm, b)
    bot_dn = mv(gm * e_col, a) + mv(gp, b)
    up = torch.cat([top_up + sysm.p_tu, (bot_up + sysm.p_bu)[-1:]], dim=0)
    dn = torch.cat([top_dn + sysm.p_td, (bot_dn + sysm.p_bd)[-1:]], dim=0)

    fup = 2.0 * math.pi * torch.einsum("j,vjB->vB", fe.wmu, up)
    fdn_diff = 2.0 * math.pi * torch.einsum("j,vjB->vB", fe.wmu, dn)

    beam_f = torch.where(fe.has_beam, fbeam, 0.0).reshape(-1)[None, :]
    mu0_b = torch.abs(umu0).reshape(-1)[None, :]
    fdir_scaled = mu0_b * beam_f * fe.eb
    rfldir = mu0_b * beam_f * fe.eb_u
    rfldn = fdn_diff + fdir_scaled - rfldir

    uavg = (
        0.5 * torch.einsum("j,vjB->vB", fe.w, up + dn)
        + beam_f * fe.eb / (4.0 * math.pi)
    )
    ssl = torch.cat([ssalb_in, ssalb_in[..., -1:]], dim=-1)
    dfdt = 4.0 * math.pi * (1.0 - to_scan(ssl)) * uavg

    def to_bm(x):
        return torch.movedim(x, 0, -1).reshape(batch + (nlyr + 1,))

    return RteOutputs(
        to_bm(rfldir), to_bm(rfldn), to_bm(fup), to_bm(dfdt), to_bm(uavg),
        None,
    )
