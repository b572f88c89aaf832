"""solve_rte — the monochromatic discrete-ordinates solve (torch port of
sbdart_tpu/solver/disort.py).

Same signature as the reference, plus `device`.  The port runs, for every
nstr whose N = nstr/2 is even and at most 8 (nstr 4, 8, 12, 16), with or
without the thermal source:

  * flux-only (onlyfl) solves on a Lambertian surface, through the
    lane-resident flux path (solver/fluxlane.py; the reference's
    `lane_ok`, disort.py:118-123);
  * radiance solves (onlyfl=False with umu and phi) on a Lambertian or
    BRDF surface, through the lane-resident radiance path
    (solver/radlane.py; the reference's `rad_lane_ok`, disort.py:154-158).

Every other combination (odd N or N > 8, flux-only BRDF, radiances
without user angles) runs on the reference's generic path and raises
NotImplementedError naming the ROADMAP slice that brings it.

Routes (`eig_method`):
  * "auto": float32 runs the kernel wrappers, which launch the CUDA
    kernels on CUDA tensors (and take the plain torch versions on CPU
    tensors); float64 runs the plain torch versions on whatever device
    the tensors are on, as the reference never sends f64 to its
    f32-only kernels, with 6 Jacobi sweeps (the reference lane route's)
    where the float32 kernel runs 3.
  * "plain": the plain torch versions, any dtype and device.

Outputs at ALL layer boundaries (the pipeline interpolates user levels).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sbdart_tpu_torch.dtypes import default_device, default_dtype, parse_dtype


class RteOutputs(NamedTuple):
    rfldir: torch.Tensor    # [..., L+1] direct flux (unscaled)
    rfldn: torch.Tensor     # [..., L+1] diffuse down flux
    flup: torch.Tensor      # [..., L+1] diffuse up flux
    dfdt: torch.Tensor      # [..., L+1] flux divergence
    uavg: torch.Tensor      # [..., L+1] mean intensity
    uu: torch.Tensor | None  # radiances (None: flux-only)


EIG_METHODS = ("auto", "plain")


def unsupported(*, nstr: int, onlyfl: bool, brdf, umu=None,
                phi=None) -> str | None:
    """The ROADMAP slice that a request needs, or None when the port
    serves it (N = nstr/2 even and <= 8; flux-only on a Lambertian
    surface, or radiances at given umu and phi on either surface; with or
    without the thermal source)."""
    n = nstr // 2
    if n % 2 or n > 8 or nstr % 2:
        return (f"nstr={nstr} (N = nstr/2 odd or above 8): ROADMAP Queue A "
                "item 7, the generic path")
    if onlyfl and brdf is not None:
        return ("a flux-only solve on a BRDF surface: ROADMAP Queue A "
                "item 7, the generic path")
    if not onlyfl and (umu is None or phi is None):
        return ("radiances (onlyfl=False) without user angles umu and phi: "
                "ROADMAP Queue A item 7, the generic path (the radiance "
                "slice ports the lane path)")
    return None


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
    why = unsupported(nstr=nstr, onlyfl=onlyfl, brdf=brdf, umu=umu, phi=phi)
    if why is not None:
        raise NotImplementedError(
            f"sbdart_tpu_torch.solve_rte does not port {why} yet"
        )
    if eig_method not in EIG_METHODS or bvp_method != "auto":
        raise ValueError(
            f"eig_method must be one of {EIG_METHODS} and bvp_method 'auto' "
            f"(got {eig_method!r}, {bvp_method!r})"
        )
    if planck and temper is None:
        raise ValueError("planck=True requires temper")
    if device is None:
        device = (dtauc.device if isinstance(dtauc, torch.Tensor)
                  else default_device())
    dtype = default_dtype(device) if dtype is None else parse_dtype(dtype)

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

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

    from sbdart_tpu_torch.kernels.eig_beam import SWEEPS_F32, SWEEPS_F64
    from sbdart_tpu_torch.solver.fluxlane import (
        PlanckInputs,
        solve_rte_flux_lane,
    )

    pk = None
    if planck:
        pk = PlanckInputs(t(temper).expand(batch + (nlyr + 1,)),
                          *(t(x).expand(batch)
                            for x in (wvnlo, wvnhi, btemp, ttemp, temis)))
    kernels = eig_method == "auto" and dtype == torch.float32
    sweeps = SWEEPS_F32 if dtype == torch.float32 else SWEEPS_F64
    if not onlyfl:
        from sbdart_tpu_torch.solver.radlane import solve_rte_radiance_lane

        return solve_rte_radiance_lane(
            dtauc, ssalb_in, pmom, nstr=nstr, fbeam=fbeam, umu0=umu0,
            phi0=phi0, fisot=fisot, albedo=albedo, deltam=deltam, umu=umu,
            phi=phi, corint=corint, planck=pk, brdf=brdf, kernels=kernels,
            sweeps=sweeps,
        )
    return solve_rte_flux_lane(
        dtauc, ssalb_in, pmom, fbeam=fbeam, umu0=umu0, fisot=fisot,
        albedo=albedo, deltam=deltam, nstr=nstr, planck=pk, kernels=kernels,
        sweeps=sweeps,
    )
