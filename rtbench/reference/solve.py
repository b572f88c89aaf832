"""The reference's monochromatic solve: the generic discrete-ordinates
route (eigen chain by torch.linalg, block-Thomas over the layers) of the
frozen solver copy in `solver/`, in whatever dtype and on whatever device
the caller names.  It runs no kernel of the program and no CUDA graph.
Later PRs do not edit this file.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rtbench.reference.ops.graph import as_device
from rtbench.reference.solver.disort import RteOutputs, solve_rte_generic


class PlanckInputs(NamedTuple):
    temper: torch.Tensor    # [..., L+1]
    wvnlo: torch.Tensor     # [...]
    wvnhi: torch.Tensor
    btemp: torch.Tensor
    ttemp: torch.Tensor
    temis: torch.Tensor


def solve(dtauc, ssalb, pmom, *, nstr, fbeam=0.0, umu0=1.0, phi0=0.0,
          fisot=0.0, albedo=0.0, planck=False, temper=None, wvnlo=0.0,
          wvnhi=0.0, btemp=0.0, ttemp=0.0, temis=0.0, deltam=True,
          onlyfl=True, dtype, device) -> RteOutputs:
    """solve_rte's arguments for fluxes (Lambertian surface, no user
    angles), broadcast as the program's entry broadcasts them, through
    the generic route."""
    def t(x):
        return as_device(x, dtype, device)

    dtauc, ssalb, pmom = t(dtauc), t(ssalb), t(pmom)
    nlyr = dtauc.shape[-1]
    fbeam, umu0, phi0, fisot, albedo = (
        t(x) for x in (fbeam, umu0, phi0, fisot, albedo))
    batch = torch.broadcast_shapes(dtauc.shape[:-1], fbeam.shape,
                                   albedo.shape)
    fbeam, umu0, phi0, fisot, albedo = (
        x.expand(batch) for x in (fbeam, umu0, phi0, fisot, albedo))
    dtauc = dtauc.expand(batch + (nlyr,))
    ssalb = ssalb.expand(batch + (nlyr,))
    pmom = pmom.expand(batch + pmom.shape[-2:])
    pk = None
    if planck:
        pk = PlanckInputs(t(temper).expand(batch + (nlyr + 1,)),
                          *(t(x).expand(batch)
                            for x in (wvnlo, wvnhi, btemp, ttemp, temis)))
    return solve_rte_generic(
        dtauc, ssalb, pmom, nstr=nstr, fbeam=fbeam, umu0=umu0, phi0=phi0,
        fisot=fisot, albedo=albedo, deltam=deltam, onlyfl=onlyfl,
        planck=pk, kernels=False,
        bvp_method="scan")
