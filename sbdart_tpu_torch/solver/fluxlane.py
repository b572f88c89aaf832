"""Lane-resident flux path (torch port of sbdart_tpu/solver/fluxlane.py),
for nstr with N = nstr/2 even and <= 8, with or without the thermal
(Planck) source.

The whole flux-only (azimuth mode 0) solve runs in one column-minor
layout [L, *, B].  The front end emits every per-layer quantity:

  * nstr=4 without Planck: the B1 kernel (kernels/eig_n2.py) from the raw
    optics (delta-M inside the kernel);
  * nstr=4 with Planck: delta-M in glue, then the B3 kernel
    (kernels/eig_n2_scatter.py) on the scaled optics;
  * nstr 8/12/16: delta-M, the scattering matrices and beam right-hand
    side as einsums, then the B4 kernel (kernels/eig_beam.py).

The boundary-value problem goes to the kernel the reference runs at each
shape (kernels/blocktri_rt_streamed.py:solve_bvp): B2
(kernels/blocktri_n2.py) at N = 2 up to 51 layers, B6
(kernels/blocktri_rt_streamed.py) where the reference streams its solve
(at N = 8 from 42 layers on, at N = 2 from 473), B5
(kernels/blocktri_rt.py) elsewhere.  With Planck, the thermal
particular solution is one kernel too (kernels/thermal.py), written in
scan layout.  Plain torch glue does the rest: tau cumsums, beam
exponentials, the particular solution at layer bounds, the surface and
top emission, the Lambertian surface operators, the BVP right-hand
side, boundary intensities, fluxes, uavg and dfdt.

Reference map: the DISORT call chain SOLEIG+UPBEAM+UPISOT+SETMTX+SOLVE0+
FLUXES (disort.f) as fused kernels plus glue.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from sbdart_tpu_torch.convert import tables_to_torch
from sbdart_tpu_torch.kernels.blocktri_rt_streamed import solve_bvp
from sbdart_tpu_torch.kernels.eig_beam import eig_beam_chain
from sbdart_tpu_torch.kernels.eig_n2 import eig_beam_deltam_scatter_n2
from sbdart_tpu_torch.kernels.eig_n2_scatter import eig_beam_scatter_n2
from sbdart_tpu_torch.kernels.planck import planck_band
from sbdart_tpu_torch.kernels.thermal import thermal_particular_scan
from sbdart_tpu_torch.ops.graph import const
from sbdart_tpu_torch.solver.deltam import DeltaMResult, apply_deltam
from sbdart_tpu_torch.solver.disort import RteOutputs
from sbdart_tpu_torch.solver.eig import AngularTables, angular_tables
from sbdart_tpu_torch.solver.sources import _ylm_at


def to_scan(x, nl_axis_from_end=1):
    """[batch..., L] -> [L, B] (or [batch..., L, k] -> [L, k, B])."""
    if nl_axis_from_end == 1:
        x = torch.movedim(x, -1, 0)               # [L, batch...]
        return x.reshape(x.shape[0], -1)
    x = torch.movedim(x, -2, 0)                   # [L, batch..., k]
    x = x.reshape(x.shape[0], -1, x.shape[-1])    # [L, B, k]
    return torch.movedim(x, -1, 1)                # [L, k, B]


class FrontEnd(NamedTuple):
    """Per-layer quantities in scan layout, from the front-end kernel."""
    tab: AngularTables    # numpy tables (one mode)
    w: torch.Tensor       # [N] quadrature weights
    wmu: torch.Tensor     # [N] w * mu
    kk: torch.Tensor      # [L, N, B]
    gp: torch.Tensor      # [L, N, N, B]
    gm: torch.Tensor      # [L, N, N, B]
    zp: torch.Tensor      # [L, N, B]
    zm: torch.Tensor      # [L, N, B]
    ee: torch.Tensor      # [L, N, B]
    eb: torch.Tensor      # [L+1, B] scaled-tau beam attenuation
    eb_u: torch.Tensor    # [L+1, B] unscaled-tau beam attenuation
    mu0: torch.Tensor     # [batch] beam cosine (dithered where no beam)
    has_beam: torch.Tensor  # [batch] bool
    dm: DeltaMResult | None  # batch-major delta-M (None on the B1 head)
    dtau_scan: torch.Tensor  # [L, B] scaled optical depth


class PlanckInputs(NamedTuple):
    """The thermal source's inputs, broadcast to the batch."""
    temper: torch.Tensor  # [batch..., L+1] level temperatures (K)
    wvnlo: torch.Tensor   # [batch] band edges (cm^-1)
    wvnhi: torch.Tensor
    btemp: torch.Tensor   # [batch] surface temperature (<= 0: temper[-1])
    ttemp: torch.Tensor   # [batch] top temperature (<= 0: temper[0])
    temis: torch.Tensor   # [batch] top emissivity


def beam_rows(fbeam, umu0):
    """(has_beam [batch], mu0 [batch], scale [1, B], mu0 [1, B])."""
    has_beam = fbeam > 0.0
    mu0 = torch.where(has_beam, torch.abs(umu0), 0.5)
    scale_row = (torch.where(has_beam, fbeam, 0.0) / (2.0 * math.pi)) \
        .reshape(1, -1)
    return has_beam, mu0, scale_row, mu0.reshape(1, -1)


def front_operands(dtauc, ssalb_in, pmom, *, fbeam, umu0, deltam):
    """The B1 kernel's operands in scan layout, from batch-major inputs:
    (dtau [L, B], ssalb [L, B], pmom5 [L, 5, B], scale [1, B], mu0 [1, B]),
    and whether delta-M applies."""
    _, _, scale_row, mu0_row = beam_rows(fbeam, umu0)
    pm5 = pmom[..., :5]
    if pm5.shape[-1] < 5:
        pm5 = F.pad(pm5, (0, 5 - pm5.shape[-1]))
    ops = (to_scan(dtauc), to_scan(ssalb_in), to_scan(pm5, 2),
           scale_row, mu0_row)
    return ops, bool(deltam) and pmom.shape[-1] > 4


def scatter_operands(dm: DeltaMResult, scale_row, mu0_row):
    """The B3 kernel's operands: (ssalb [L, B], gl [L, 4, B], scale [1, B],
    mu0 [1, B]) from the batch-major delta-M result."""
    return to_scan(dm.ssalb), to_scan(dm.gl, 2), scale_row, mu0_row


def general_operands(dm: DeltaMResult, tab, mu0, scale_row):
    """The B4 kernel's operands (fluxlane.py:152-181): (cppl, cpml
    [L, N, N, B], r1, r2 [L, N, B], mu0 [1, B]), built as einsums in scan
    layout from the batch-major delta-M result and beam cosine mu0."""
    dtype, device = dm.ssalb.dtype, dm.ssalb.device
    nstr = len(tab.twol1)
    n = nstr // 2
    nlyr = dm.ssalb.shape[-1]

    def t(x):
        return const(x, dtype, device)

    c = 0.5 * dm.ssalb[..., None] * t(tab.twol1) * dm.gl   # [.., L, nstr]
    c_scan = to_scan(c, 2)                                 # [L, nstr, Bc]
    bc = c_scan.shape[-1]
    ylm0 = np.asarray(tab.ylm[0], np.float64)              # [nstr, N]
    par0 = np.asarray(tab.parity[0], np.float64)
    a_pp = t((ylm0[:, :, None] * ylm0[:, None, :]).reshape(nstr, n * n))
    a_pm = a_pp * t(par0)[:, None]
    cppl = torch.einsum("lk,SlB->SkB", a_pp, c_scan).reshape(nlyr, n, n, bc)
    cpml = torch.einsum("lk,SlB->SkB", a_pm, c_scan).reshape(nlyr, n, n, bc)

    y0 = _ylm_at(mu0, 1, nstr)[..., 0, :]                  # [batch.., nstr]
    y0d = y0 * t(par0)
    prod = c_scan * y0d.reshape(-1, nstr).T[None, :, :]    # [L, nstr, Bc]
    ylm_mat = t(ylm0.T)                                    # [N, nstr]
    scale = scale_row[0][None, None, :]
    x0p = torch.einsum("il,SlB->SiB", ylm_mat, prod) * scale
    x0m = torch.einsum("il,SlB->SiB", ylm_mat * t(par0)[None, :], prod) \
        * scale
    inv_mu_col = t(1.0 / tab.mu)[None, :, None]
    r1 = (x0p + x0m) * inv_mu_col                          # [L, N, Bc]
    r2 = (x0p - x0m) * inv_mu_col
    return cppl, cpml, r1, r2, mu0.reshape(1, -1)


def front_end(dtauc, ssalb_in, pmom, *, fbeam, umu0, deltam, nstr=4,
              planck=False) -> FrontEnd:
    """Optics -> eigen/beam quantities (fluxlane.py:59-188).  Inputs are
    batch-major and already broadcast."""
    n = nstr // 2
    tab = angular_tables(nstr, 1)
    tab_t = tables_to_torch(tab, device=dtauc.device, dtype=dtauc.dtype)
    has_beam, mu0, scale_row, mu0_row = beam_rows(fbeam, umu0)
    has_beam_row = has_beam.reshape(1, -1)
    dm = None
    if n == 2 and not planck:
        ops, use_dm = front_operands(dtauc, ssalb_in, pmom, fbeam=fbeam,
                                     umu0=umu0, deltam=deltam)
        kk, gp, gm, zp, zm, dtau_scan, ee = eig_beam_deltam_scatter_n2(
            *ops, tab, use_deltam=use_dm)
        zrow = torch.zeros_like(mu0_row)
        tau_s_scan = torch.cat([zrow, torch.cumsum(dtau_scan, dim=0)])
        tau_u_scan = torch.cat([zrow, torch.cumsum(ops[0], dim=0)])
        eb = torch.where(has_beam_row, torch.exp(-tau_s_scan / mu0_row), 0.0)
        eb_u = torch.where(has_beam_row, torch.exp(-tau_u_scan / mu0_row),
                           0.0)
    else:
        dm = apply_deltam(dtauc, ssalb_in, pmom, nstr, deltam)

        def attenuation(dtau):
            tau = torch.cumsum(dtau, dim=-1)
            tau = torch.cat([torch.zeros_like(tau[..., :1]), tau], dim=-1)
            return to_scan(torch.where(has_beam[..., None],
                                       torch.exp(-tau / mu0[..., None]), 0.0))

        eb = attenuation(dm.dtau)                          # [L+1, Bc]
        eb_u = attenuation(dm.dtau_unscaled)
        dtau_scan = to_scan(dm.dtau)
        if n == 2:
            kk, gp, gm, zp, zm = eig_beam_scatter_n2(
                *scatter_operands(dm, scale_row, mu0_row), tab)
        else:
            ops = general_operands(dm, tab, mu0, scale_row)
            kk, gp, gm, zp, zm = eig_beam_chain(*ops, tab.mu, tab.w)
        ee = torch.exp(-kk * dtau_scan[:, None, :])        # [L, N, Bc]
    return FrontEnd(tab, tab_t.w, tab_t.w * tab_t.mu, kk, gp, gm, zp, zm,
                    ee, eb, eb_u, mu0, has_beam, dm, dtau_scan)


class BvpSystem(NamedTuple):
    """Operands of the BVP solve plus the particular solution at bounds."""
    refl: torch.Tensor    # [N, N, B] Lambertian operator R[i, k] w_k mu_k
    rhs: torch.Tensor     # [L, 2N, B]
    p_tu: torch.Tensor    # [L, N, B] particular solution, layer tops (+mu)
    p_td: torch.Tensor    # [L, N, B]                      layer tops (-mu)
    p_bu: torch.Tensor    # [L, N, B]                   layer bottoms (+mu)
    p_bd: torch.Tensor    # [L, N, B]                   layer bottoms (-mu)
    b_level: torch.Tensor | None  # [L+1, B] Planck at levels (thermal)


def bvp_system(fe: FrontEnd, *, fbeam, fisot, albedo,
               planck: PlanckInputs | None = None) -> BvpSystem:
    """Particular solution at layer bounds (the thermal one added when
    `planck` is given), surface and top emission, the Lambertian surface
    operators and the BVP right-hand side (fluxlane.py:190-274)."""
    n = fe.kk.shape[1]
    eb = fe.eb
    p_tu = fe.zp * eb[:-1, None, :]
    p_td = fe.zm * eb[:-1, None, :]
    p_bu = fe.zp * eb[1:, None, :]
    p_bd = fe.zm * eb[1:, None, :]

    dtype, device = eb.dtype, eb.device
    iso = fisot.reshape(-1)
    semis = None
    b_level = None
    if planck is not None:
        b_level, semis, top_emission, (y0p, y0m, y1p, y1m) = _thermal(
            fe, planck, albedo)
        iso = iso + top_emission.reshape(-1)
        d_scan = fe.dtau_scan[:, None, :]
        p_tu = p_tu + y0p
        p_td = p_td + y0m
        p_bu = p_bu + y0p + y1p * d_scan
        p_bd = p_bd + y0m + y1m * d_scan

    alb_flat = albedo.reshape(-1)                        # [Bc]
    beam_flux_flat = (
        fe.mu0.reshape(-1) * torch.where(fe.has_beam, fbeam, 0.0).reshape(-1)
        * eb[-1]
    )                                                    # [Bc]
    refl = (
        2.0 * alb_flat[None, None, :] * fe.wmu[None, :, None]
        * torch.ones((n, 1, 1), dtype=dtype, device=device)
    )                                                    # [N, N, Bc]
    bref = ((alb_flat / math.pi) * beam_flux_flat)[None, :].expand(n, -1)

    r_top0 = iso[None, :] - p_td[0]
    r_topl = p_bd[:-1] - p_td[1:]
    r_top = torch.cat([r_top0[None], r_topl], dim=0)
    r_botl = p_tu[1:] - p_bu[:-1]
    refl_part = torch.sum(refl * p_bd[-1][None, :, :], dim=1)
    src = bref if semis is None else semis + bref
    r_botL = src + refl_part - p_bu[-1]
    r_bot = torch.cat([r_botl, r_botL[None]], dim=0)
    rhs = torch.cat([r_top, r_bot], dim=1)               # [L, 2N, Bc]
    return BvpSystem(refl, rhs, p_tu, p_td, p_bu, p_bd, b_level)


def _thermal(fe: FrontEnd, pk: PlanckInputs, albedo):
    """Planck at the levels, the thermal particular solution in scan
    layout, and the surface/top emission (fluxlane.py:200-243), through
    the P1 and P2 wrappers (kernels/planck.py, kernels/thermal.py).
    Planck is evaluated in the working dtype: float32 on the kernel path,
    as the reference's lane path does, float64 on the f64 route, as its
    generic path does."""
    dm, tab = fe.dm, fe.tab
    dtype = dm.ssalb.dtype
    b_level = planck_band(pk.wvnlo[..., None], pk.wvnhi[..., None],
                          pk.temper, dtype)
    # Y0+-, Y1+- [L, N, B]
    y = thermal_particular_scan(dm.ssalb, dm.dtau, dm.gl, b_level, tab)
    btemp_eff = torch.where(pk.btemp > 0, pk.btemp, pk.temper[..., -1])
    ttemp_eff = torch.where(pk.ttemp > 0, pk.ttemp, pk.temper[..., 0])
    surf_emission = (1.0 - albedo) * planck_band(pk.wvnlo, pk.wvnhi,
                                                 btemp_eff, dtype)
    top_emission = pk.temis * planck_band(pk.wvnlo, pk.wvnhi, ttemp_eff,
                                          dtype)
    n = fe.kk.shape[1]
    semis = surf_emission.reshape(-1)[None, :].expand(n, -1)
    return to_scan(b_level), semis, top_emission, y


def solve_rte_flux_lane(dtauc, ssalb_in, pmom, *, fbeam, umu0, fisot,
                        albedo, deltam, nstr=4, planck: PlanckInputs | None
                        = None) -> RteOutputs:
    """Flux-mode solve, lane-resident.  Inputs batch-major as in
    solve_rte (already broadcast, one dtype and device); `planck` turns
    the thermal source on.  Returns RteOutputs with uu=None."""
    nlyr = dtauc.shape[-1]
    batch = tuple(dtauc.shape[:-1])
    fe = front_end(dtauc, ssalb_in, pmom, fbeam=fbeam, umu0=umu0,
                   deltam=deltam, nstr=nstr, planck=planck is not None)
    sysm = bvp_system(fe, fbeam=fbeam, fisot=fisot, albedo=albedo,
                      planck=planck)
    n = nstr // 2
    xs = solve_bvp(fe.gp, fe.gm, fe.ee, sysm.refl, sysm.rhs)
    a = xs[:, :n]                                        # [L, N, Bc]
    b = xs[:, n:]

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
    src = uavg if sysm.b_level is None else uavg - sysm.b_level
    dfdt = 4.0 * math.pi * (1.0 - to_scan(ssl)) * src

    def to_bm(x):
        return torch.movedim(x, 0, -1).reshape(batch + (nlyr + 1,))

    return RteOutputs(
        to_bm(rfldir), to_bm(rfldn), to_bm(fup), to_bm(dfdt), to_bm(uavg),
        None,
    )
