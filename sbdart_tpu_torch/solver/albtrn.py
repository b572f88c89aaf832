"""Slab albedo / transmissivity mode (torch port of
sbdart_tpu/solver/albtrn.py).

Replaces disort.f:ALBTRN/ALTRIN/SPALTR (the IBCND=1 special mode): the
plane albedo and total transmissivity of the whole inhomogeneous slab as a
function of incident beam angle, with no thermal emission.

As in the reference, this is the batched beam problem broadcast over the
incidence angles: an angle axis in front of the layer axis, a unit beam at
each incidence cosine, one flux-only solve_rte (at nstr=4 in float32 the
fluxlane route, so the B1 and B2 kernels on the card).
"""

from __future__ import annotations

import torch

from sbdart_tpu_torch.dtypes import default_device, default_dtype, parse_dtype
from sbdart_tpu_torch.solver.disort import solve_rte


def slab_albedo_transmission(
    dtauc,                   # [..., L]
    ssalb,                   # [..., L]
    pmom,                    # [..., L, nmom]
    *,
    nstr: int,
    umu,                     # [U] incidence cosines (> 0)
    albedo=0.0,
    deltam: bool = True,
    dtype=None,
    eig_method: str = "auto",
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(albmed, trnmed), each [..., U].

    albmed: plane albedo for a unit beam at incidence cosine umu[j];
    trnmed: total (direct + diffuse) transmissivity.  `albedo` is the
    surface's (the reference passes the namelist's albcon through);
    `eig_method` and `device` as in solve_rte.
    """
    if device is None:
        device = (dtauc.device if isinstance(dtauc, torch.Tensor)
                  else default_device())
    dtype = default_dtype(device) if dtype is None else parse_dtype(dtype)
    dtauc, ssalb, pmom, umu = (
        torch.as_tensor(x, dtype=dtype, device=device)
        for x in (dtauc, ssalb, pmom, umu))
    umu = umu.abs()
    nu = umu.shape[0]
    dtau_b = dtauc[..., None, :]                      # add the angle axis
    ssalb_b = ssalb[..., None, :]
    pmom_b = pmom[..., None, :, :]
    out = solve_rte(
        dtau_b.expand(dtau_b.shape[:-2] + (nu,) + dtau_b.shape[-1:]),
        ssalb_b.expand(ssalb_b.shape[:-2] + (nu,) + ssalb_b.shape[-1:]),
        pmom_b.expand(pmom_b.shape[:-3] + (nu,) + pmom_b.shape[-2:]),
        nstr=nstr,
        fbeam=torch.ones_like(umu),
        umu0=umu,
        albedo=albedo,
        deltam=deltam,
        onlyfl=True,
        dtype=dtype,
        eig_method=eig_method,
        device=device,
    )
    inc = umu  # mu0 * fbeam
    albmed = out.flup[..., 0] / inc
    trnmed = (out.rfldir[..., -1] + out.rfldn[..., -1]) / inc
    return albmed, trnmed
