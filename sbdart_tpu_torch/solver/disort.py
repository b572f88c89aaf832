"""solve_rte — the monochromatic discrete-ordinates solve (torch port of
sbdart_tpu/solver/disort.py).

Same signature as the reference, plus `device`.  This slice of the port
runs the main path only: flux-only (onlyfl), Lambertian surface, nstr=4,
no thermal source, through the lane-resident flux path
(solver/fluxlane.py) and its two CUDA kernels.  Every other combination
raises NotImplementedError naming the ROADMAP slice that brings it.

Routes (`eig_method`):
  * "auto": float32 runs the kernel wrappers, which launch the CUDA
    kernels on CUDA tensors (and take the plain torch versions on CPU
    tensors); float64 runs the plain torch versions on whatever device
    the tensors are on, as the reference never sends f64 to its
    f32-only kernels.
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


def unsupported(*, nstr: int, planck: bool, onlyfl: bool, brdf) -> str | None:
    """The ROADMAP slice that a request needs, or None when this slice
    (nstr=4 solar flux, Lambertian) serves it."""
    if planck:
        return ("thermal source (planck=True): ROADMAP Queue A item 6, "
                "the nstr=4 thermal slice")
    if not onlyfl:
        return ("radiances (onlyfl=False): ROADMAP Queue A item 9, "
                "the radiance slice")
    if brdf is not None:
        return ("BRDF surface: ROADMAP Queue A item 9, the radiance/BRDF "
                "slice")
    if nstr != 4:
        return (f"nstr={nstr}: ROADMAP Queue A item 8, the nstr 8/16 "
                "slice (general-n kernels B4-B6)")
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
    why = unsupported(nstr=nstr, planck=planck, onlyfl=onlyfl, brdf=brdf)
    if why is not None:
        raise NotImplementedError(
            f"sbdart_tpu_torch.solve_rte does not port {why} yet"
        )
    if eig_method not in EIG_METHODS or bvp_method != "auto":
        raise ValueError(
            f"eig_method must be one of {EIG_METHODS} and bvp_method 'auto' "
            f"(got {eig_method!r}, {bvp_method!r})"
        )
    if device is None:
        device = (dtauc.device if isinstance(dtauc, torch.Tensor)
                  else default_device())
    dtype = default_dtype(device) if dtype is None else parse_dtype(dtype)

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    dtauc, ssalb_in, pmom = t(dtauc), t(ssalb), t(pmom)
    nlyr = dtauc.shape[-1]
    fbeam, umu0, fisot, albedo = t(fbeam), t(umu0), t(fisot), t(albedo)
    batch = torch.broadcast_shapes(dtauc.shape[:-1], fbeam.shape,
                                   albedo.shape)
    fbeam, umu0, fisot, albedo = (
        x.expand(batch) for x in (fbeam, umu0, fisot, albedo)
    )
    dtauc = dtauc.expand(batch + (nlyr,))
    ssalb_in = ssalb_in.expand(batch + (nlyr,))
    pmom = pmom.expand(batch + pmom.shape[-2:])

    from sbdart_tpu_torch.solver.fluxlane import solve_rte_flux_lane

    kernels = eig_method == "auto" and dtype == torch.float32
    return solve_rte_flux_lane(
        dtauc, ssalb_in, pmom, fbeam=fbeam, umu0=umu0, fisot=fisot,
        albedo=albedo, deltam=deltam, kernels=kernels,
    )
