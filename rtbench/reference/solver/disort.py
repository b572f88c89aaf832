# Frozen copy of sbdart_tpu_torch/solver/disort.py for the benchmark's reference: imports
# point into rtbench.reference; reduced to the generic route's fluxes on a Lambertian surface, the fused front end, the BRDF branch and the radiances taken out.
# Later changes do not edit it.
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
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from rtbench.reference.ops.graph import as_device, const


class RteOutputs(NamedTuple):
    rfldir: torch.Tensor    # [..., L+1] direct flux (unscaled)
    rfldn: torch.Tensor     # [..., L+1] diffuse down flux
    flup: torch.Tensor      # [..., L+1] diffuse up flux
    dfdt: torch.Tensor      # [..., L+1] flux divergence
    uavg: torch.Tensor      # [..., L+1] mean intensity
    uu: torch.Tensor | None  # radiances (None: flux-only)


def solve_rte_generic(dtauc, ssalb_in, pmom, *, nstr, fbeam, umu0, phi0,
                      fisot, albedo, deltam, onlyfl, planck=None,
                      kernels=True, bvp_method="auto") -> RteOutputs:
    """The generic path (disort.py:181-329).  Inputs batch-major and
    already broadcast (as in solve_rte, one dtype and device); `planck`
    the PlanckInputs (None: no thermal source); `kernels` picks the kernel
    wrappers over their plain versions on the float32 route; `bvp_method`
    as in solve_rte."""
    from rtbench.reference.solver import bvp as bvp_mod
    from rtbench.reference.solver.deltam import apply_deltam
    from rtbench.reference.solver.eig import angular_tables, solve_eigen
    from rtbench.reference.solver.fields import fluxes
    from rtbench.reference.solver.planck import planck_band
    from rtbench.reference.solver.sources import (
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
    eig = solve_eigen(dm.ssalb, dm.gl, tab, eig_method="xla")
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
    if True:  # Lambertian surface only
        ones_nn = torch.ones((n, n), dtype=dtype, device=device)
        surf_refl = (2.0 * albedo[..., None, None, None]
                     * mode0_vec[:, None, None] * ones_nn)   # [..., m, N, N]
        beam_refl_src = (((albedo / math.pi) * beam_flux_surf)[..., None, None]
                         * mode0_vec[:, None])               # [..., m, N]
        surf_emis_vec = surf_emission[..., None].expand(batch + (n,))
    sol = bvp_mod.solve_bvp(eig, part, dm.dtau, surf_refl, fisot,
                            top_emission, surf_emis_vec, beam_refl_src, tab,
                            kernels=kernels, method=bvp_method)
    bounds = bvp_mod.intensity_at_boundaries(eig, sol, part, dm.dtau)
    fx = fluxes(bounds, tab, fbeam, mu0, expbea_s, expbea_u, ssalb_in,
                b_level)

    return RteOutputs(fx.rfldir, fx.rfldn, fx.flup, fx.dfdt, fx.uavg, None)
