"""solve_rte — the monochromatic discrete-ordinates solve (torch port of
sbdart_tpu/solver/disort.py).

Same signature as the reference, plus `device`.  Routes (`route`), in the
reference's order:

  * flux-only solves on a Lambertian surface with N = nstr/2 even and at
    most 8 (nstr 4, 8, 12, 16): the lane-resident flux path
    (solver/fluxlane.py; the reference's `lane_ok`, disort.py:118-123);
  * radiance solves (onlyfl=False with umu and phi) with N even and at
    most 8, on either surface: the lane-resident radiance path
    (solver/radlane.py; the reference's `rad_lane_ok`, disort.py:154-158);
  * everything else -- odd N (nstr 2, 6, 10, 14), N > 8, flux-only solves
    on a BRDF surface, all-mode solves without user angles: the generic
    path (disort.py:181-329: solver/eig.py, sources.py, bvp.py, fields.py,
    radiance.py).  In float32 it takes the reference's TPU route (B9 or
    the fused front end B4/B8, B2/B5/B6 for the BVP, at every N: past
    N = 8 B5 and B6 run their group-per-column kernels); in float64 its
    CPU route (torch.linalg eigh/Cholesky/solve and the lane
    block-Thomas).

Methods (`eig_method`):
  * "auto": float32 runs the kernel wrappers, which launch the CUDA
    kernels on CUDA tensors (and take the plain torch versions on CPU
    tensors); float64 runs the plain torch versions on whatever device
    the tensors are on, as the reference never sends f64 to its
    f32-only kernels, with 6 Jacobi sweeps (the reference lane route's)
    where the float32 kernels run 3.
  * "plain": the plain torch versions, any dtype and device.
Both plain cases run the solve inside kernels/__init__.py:plain(), which
every wrapper obeys; nothing below solve_rte picks kernel or plain.

BVP methods (`bvp_method`, the generic path's, as the reference's lane
paths take none):
  * "auto": the reference's routing (solver/bvp.py:178-191): float32 runs
    the BVP kernel the reference runs at the shape (B2, B5 or B6, which
    assemble the blocks on the fly), float64 assembles the blocks and runs
    the lane block-Thomas;
  * "scan": the reference's assembled-block route at every dtype
    (assemble_blocks + block-Thomas); in float32 the elimination runs in
    B10 (kernels/blocktri.py), the kernel the reference holds equal to
    that scan (tests/test_pallas_kernels.py:20-29).

Without `device` and without tensor inputs the solve runs on the CUDA card,
or on the CPU where the caller asks (`dtypes.default_device`).

Outputs at ALL layer boundaries (the pipeline interpolates user levels).

Which solves the pipeline and the batch capture into a CUDA graph
(ops/graph.py:CapturedCall) is a fixed rule of the route (`eager_reason`;
`graph_ok` is its negation), never a caught error:

  | device | dtype   | route                      | captured |
  | ------ | ------- | -------------------------- | -------- |
  | CPU    | any     | any                        | no: CUDA graphs exist on CUDA devices only; the plain path runs eagerly |
  | CUDA   | float64 | any                        | no: the float64 route is the plain accuracy reference, and its generic path's eigen chain is torch.linalg (cuSOLVER eigh, Cholesky, solve), whose info torch checks on the host |
  | CUDA   | float32 | flux_lane, radiance_lane   | yes |
  | CUDA   | float32 | generic, eig_route not xla | yes: B9 or the lane chain, every op a kernel |
  | CUDA   | float32 | generic, eig_route xla     | no: the eigen chain is torch.linalg (cuSOLVER), which checks its info on the host |

A capture that fails on a route the rule admits raises.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch

from sbdart_tpu_torch import kernels
from sbdart_tpu_torch.dtypes import default_device, default_dtype, parse_dtype
from sbdart_tpu_torch.ops.graph import as_device, const
from sbdart_tpu_torch.solver.eig import eig_route


class RteOutputs(NamedTuple):
    rfldir: torch.Tensor    # [..., L+1] direct flux (unscaled)
    rfldn: torch.Tensor     # [..., L+1] diffuse down flux
    flup: torch.Tensor      # [..., L+1] diffuse up flux
    dfdt: torch.Tensor      # [..., L+1] flux divergence
    uavg: torch.Tensor      # [..., L+1] mean intensity
    uu: torch.Tensor | None  # radiances (None: flux-only)


EIG_METHODS = ("auto", "plain")
BVP_METHODS = ("auto", "scan")


def route(*, nstr: int, onlyfl: bool, brdf, umu=None, phi=None) -> str:
    """The path a request takes: "flux_lane", "radiance_lane" or
    "generic" (disort.py:118-181)."""
    n = nstr // 2
    lane_n = n <= 8 and n % 2 == 0
    if onlyfl and brdf is None and lane_n:
        return "flux_lane"
    if not onlyfl and umu is not None and phi is not None and lane_n:
        return "radiance_lane"
    return "generic"


def eager_reason(route: str, nstr: int, dtype: torch.dtype,
                 device) -> str | None:
    """Why a solve on `route` at `nstr` in `dtype` on `device` runs
    eagerly, or None where it is captured (the module docstring's
    table)."""
    if torch.device(device).type != "cuda":
        return "cpu: CUDA graphs exist on CUDA devices only"
    if dtype != torch.float32:
        return ("float64: the plain accuracy route; its generic path's "
                "eigen chain is torch.linalg (cuSOLVER), whose info torch "
                "checks on the host")
    if route == "generic" and eig_route(nstr // 2, dtype) == "xla":
        return ("generic N > 16: the eigen chain is torch.linalg (cuSOLVER "
                "eigh, Cholesky, solve), whose info torch checks on the host")
    return None


def graph_ok(route: str, nstr: int, dtype: torch.dtype, device) -> bool:
    """Whether such a solve is captured into a CUDA graph (eager_reason)."""
    return eager_reason(route, nstr, dtype, device) is None


def solve_rte(
    dtauc,                       # [..., L]
    ssalb,                       # [..., L]
    pmom,                        # [..., L, nmom]
    *,
    nstr: int,
    fbeam=0.0,                   # [...]
    umu0=1.0,
    phi0=0.0,
    fisot=0.0,
    albedo=0.0,
    planck: bool = False,
    temper=None,                 # [..., L+1]
    wvnlo=0.0,
    wvnhi=0.0,
    btemp=0.0,
    ttemp=0.0,
    temis=0.0,
    deltam: bool = True,
    onlyfl: bool = True,
    umu=None,
    phi=None,
    corint: bool = True,
    brdf=None,
    dtype=None,
    eig_method: str = "auto",
    bvp_method: str = "auto",
    device=None,
) -> RteOutputs:
    if eig_method not in EIG_METHODS or bvp_method not in BVP_METHODS:
        raise ValueError(
            f"eig_method must be one of {EIG_METHODS} and bvp_method one of "
            f"{BVP_METHODS} (got {eig_method!r}, {bvp_method!r})"
        )
    if planck and temper is None:
        raise ValueError("planck=True requires temper")
    if not onlyfl and umu is not None and phi is None:
        raise ValueError("radiances at user cosines umu need the azimuths "
                         "phi")
    if device is None:
        device = (dtauc.device if isinstance(dtauc, torch.Tensor)
                  else default_device())
    dtype = default_dtype(device) if dtype is None else parse_dtype(dtype)

    def t(x):
        return as_device(x, dtype, device)

    dtauc, ssalb_in, pmom = t(dtauc), t(ssalb), t(pmom)
    nlyr = dtauc.shape[-1]
    fbeam, umu0, phi0, fisot, albedo = (
        t(x) for x in (fbeam, umu0, phi0, fisot, albedo))
    batch = torch.broadcast_shapes(dtauc.shape[:-1], fbeam.shape,
                                   albedo.shape)
    fbeam, umu0, phi0, fisot, albedo = (
        x.expand(batch) for x in (fbeam, umu0, phi0, fisot, albedo)
    )
    dtauc = dtauc.expand(batch + (nlyr,))
    ssalb_in = ssalb_in.expand(batch + (nlyr,))
    pmom = pmom.expand(batch + pmom.shape[-2:])

    from sbdart_tpu_torch.solver.fluxlane import (
        PlanckInputs,
        solve_rte_flux_lane,
    )

    pk = None
    if planck:
        pk = PlanckInputs(t(temper).expand(batch + (nlyr + 1,)),
                          *(t(x).expand(batch)
                            for x in (wvnlo, wvnhi, btemp, ttemp, temis)))
    path = route(nstr=nstr, onlyfl=onlyfl, brdf=brdf, umu=umu, phi=phi)
    with (kernels.plain() if eig_method == "plain" or dtype != torch.float32
          else contextlib.nullcontext()):
        if path == "radiance_lane":
            from sbdart_tpu_torch.solver.radlane import (
                solve_rte_radiance_lane,
            )

            return solve_rte_radiance_lane(
                dtauc, ssalb_in, pmom, nstr=nstr, fbeam=fbeam, umu0=umu0,
                phi0=phi0, fisot=fisot, albedo=albedo, deltam=deltam,
                umu=umu, phi=phi, corint=corint, planck=pk, brdf=brdf,
            )
        if path == "flux_lane":
            return solve_rte_flux_lane(
                dtauc, ssalb_in, pmom, fbeam=fbeam, umu0=umu0, fisot=fisot,
                albedo=albedo, deltam=deltam, nstr=nstr, planck=pk,
            )
        return solve_rte_generic(
            dtauc, ssalb_in, pmom, nstr=nstr, fbeam=fbeam, umu0=umu0,
            phi0=phi0, fisot=fisot, albedo=albedo, deltam=deltam,
            onlyfl=onlyfl, umu=umu, phi=phi, corint=corint, planck=pk,
            brdf=brdf, bvp_method=bvp_method,
        )


def solve_rte_generic(dtauc, ssalb_in, pmom, *, nstr, fbeam, umu0, phi0,
                      fisot, albedo, deltam, onlyfl, umu, phi, corint,
                      planck=None, brdf=None, bvp_method="auto") -> RteOutputs:
    """The generic path (disort.py:181-329).  Inputs batch-major and
    already broadcast (as in solve_rte, one dtype and device); `planck`
    the PlanckInputs (None: no thermal source); `bvp_method` as in
    solve_rte."""
    from sbdart_tpu_torch.kernels.planck import planck_band
    from sbdart_tpu_torch.solver import bvp as bvp_mod
    from sbdart_tpu_torch.solver.deltam import apply_deltam
    from sbdart_tpu_torch.solver.eig import (
        angular_tables,
        solve_eigen,
        solve_eigen_beam_fused,
    )
    from sbdart_tpu_torch.solver.fields import fluxes
    from sbdart_tpu_torch.solver.sources import (
        beam_particular,
        thermal_particular,
    )

    dtype, device = dtauc.dtype, dtauc.device
    batch = tuple(dtauc.shape[:-1])
    nmode = 1 if onlyfl else nstr
    n = nstr // 2
    tab = angular_tables(nstr, nmode)

    # ---- optical property scaling (SETDIS) ---------------------------------
    dm = apply_deltam(dtauc, ssalb_in, pmom, nstr, deltam)

    def tau_levels(dtau):
        tau = torch.cumsum(dtau, dim=-1)
        return torch.cat([torch.zeros_like(tau[..., :1]), tau], dim=-1)

    tau_s = tau_levels(dm.dtau)
    tau_u = tau_levels(dm.dtau_unscaled)
    has_beam = fbeam > 0.0
    mu0 = torch.where(has_beam, torch.abs(umu0), 0.5)
    expbea_s = torch.where(has_beam[..., None],
                           torch.exp(-tau_s / mu0[..., None]), 0.0)
    expbea_u = torch.where(has_beam[..., None],
                           torch.exp(-tau_u / mu0[..., None]), 0.0)

    # ---- homogeneous + particular solutions ------------------------------
    # float32 flux-mode solves with N even and <= 8: the fused front end
    # (the eigen chain and the beam solve in one kernel, B4 or B8)
    if nmode == 1 and n <= 8 and n % 2 == 0 and dtype == torch.float32:
        eig, beam = solve_eigen_beam_fused(
            dm.ssalb, dm.gl, fbeam, mu0, tab,
            need_cppcpm=planck is not None)
    else:
        eig = solve_eigen(dm.ssalb, dm.gl, tab)
        beam = beam_particular(eig.cpp, eig.cpm, dm.ssalb, dm.gl, fbeam,
                               mu0, tab)

    thermal = None
    b_level = None
    zeros = torch.zeros(batch, dtype=dtype, device=device)
    top_emission = surf_emission = zeros
    if planck is not None:
        b_level = planck_band(planck.wvnlo[..., None],
                              planck.wvnhi[..., None], planck.temper, dtype)
        thermal = thermal_particular(
            eig.cpp[..., 0, :, :, :], eig.cpm[..., 0, :, :, :], dm.ssalb,
            dm.dtau, b_level, tab)
        btemp_eff = torch.where(planck.btemp > 0, planck.btemp,
                                planck.temper[..., -1])
        ttemp_eff = torch.where(planck.ttemp > 0, planck.ttemp,
                                planck.temper[..., 0])
        surf_emission = (1.0 - albedo) * planck_band(
            planck.wvnlo, planck.wvnhi, btemp_eff, dtype)
        top_emission = planck.temis * planck_band(
            planck.wvnlo, planck.wvnhi, ttemp_eff, dtype)

    part = bvp_mod.particular_at_bounds(beam, thermal, expbea_s, dm.dtau,
                                        nmode)

    # ---- surface operators (SURFAC/BDREF) ----------------------------------
    mode0_vec = const(np.arange(nmode) == 0, dtype, device)   # 1 on mode 0
    beam_flux_surf = mu0 * torch.where(has_beam, fbeam, 0.0) * expbea_s[..., -1]
    if brdf is None:
        ones_nn = torch.ones((n, n), dtype=dtype, device=device)
        surf_refl = (2.0 * albedo[..., None, None, None]
                     * mode0_vec[:, None, None] * ones_nn)   # [..., m, N, N]
        beam_refl_src = (((albedo / math.pi) * beam_flux_surf)[..., None, None]
                         * mode0_vec[:, None])               # [..., m, N]
        surf_emis_vec = surf_emission[..., None].expand(batch + (n,))
    else:
        from sbdart_tpu_torch.solver.brdf import (
            fourier_refl_matrices,
            hemispherical_reflectance,
        )

        mu_q = const(tab.mu, dtype, device)
        surf_refl = fourier_refl_matrices(brdf, mu_q, mu_q, nmode).expand(
            batch + (nmode, n, n))
        r_beam = fourier_refl_matrices(brdf, mu_q, mu0[..., None],
                                       nmode)[..., :, :, 0]  # [..., m, N]
        mfac = const(np.where(np.arange(nmode) == 0, 1.0, 2.0), dtype,
                     device)
        beam_refl_src = (r_beam * mfac[:, None] / (2.0 * math.pi)
                         * beam_flux_surf[..., None, None])
        if planck is not None:
            r_dh = hemispherical_reflectance(brdf, mu_q, tab.w, tab.mu)
            bs = surf_emission / torch.clamp_min(1.0 - albedo, 1e-12)
            surf_emis_vec = (1.0 - r_dh) * bs[..., None]
        else:
            surf_emis_vec = torch.zeros(batch + (n,), dtype=dtype,
                                        device=device)

    sol = bvp_mod.solve_bvp(eig, part, dm.dtau, surf_refl, fisot,
                            top_emission, surf_emis_vec, beam_refl_src, tab,
                            method=bvp_method)
    bounds = bvp_mod.intensity_at_boundaries(eig, sol, part, dm.dtau)
    fx = fluxes(bounds, tab, fbeam, mu0, expbea_s, expbea_u, ssalb_in,
                b_level)

    uu = None
    if not onlyfl and umu is not None:
        from sbdart_tpu_torch.solver.radiance import compute_radiances

        uu = compute_radiances(
            eig=eig, sol=sol, beam=beam, thermal=thermal, dm=dm, tau_u=tau_u,
            ssalb_unscaled=ssalb_in, expbea_s=expbea_s, tab=tab, fbeam=fbeam,
            mu0=mu0, phi0=phi0, fisot=fisot, albedo=albedo,
            top_emission=top_emission, surf_emission=surf_emission,
            bounds=bounds, pmom_unscaled=pmom,
            umu=np.asarray(umu, np.float64), phi=np.asarray(phi, np.float64),
            corint=corint, brdf=brdf)
    return RteOutputs(fx.rfldir, fx.rfldn, fx.flup, fx.dfdt, fx.uavg, uu)
