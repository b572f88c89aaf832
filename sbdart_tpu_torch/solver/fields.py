"""Output fields of the generic path: fluxes, mean intensity, flux
divergence (torch port of sbdart_tpu/solver/fields.py; disort.f:FLUXES).

Conventions follow DISORT 2.0's outputs: rfldir is the direct-beam flux
without delta-M scaling; rfldn the diffuse down-flux, total down minus
rfldir (the delta-M forward peak counts as diffuse); flup the diffuse
up-flux; uavg the mean intensity (direct beam included, delta-M scaled);
dfdt = 4 pi (1 - w0)(uavg - planck).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from sbdart_tpu_torch.solver.bvp import BoundaryIntensities
from sbdart_tpu_torch.solver.eig import AngularTables


class FluxFields(NamedTuple):
    rfldir: torch.Tensor   # [..., L+1]
    rfldn: torch.Tensor    # [..., L+1]
    flup: torch.Tensor     # [..., L+1]
    dfdt: torch.Tensor     # [..., L+1]
    uavg: torch.Tensor     # [..., L+1]


def fluxes(bounds: BoundaryIntensities, tab: AngularTables, fbeam, umu0,
           expbea_scaled, expbea_true, ssalb_unscaled,
           b_level) -> FluxFields:
    """expbea_scaled/true [..., L+1]: exp(-tau/mu0) on the scaled and the
    unscaled optical depths; ssalb_unscaled [..., L]; b_level [..., L+1]
    Planck radiance at the levels (None: no thermal source)."""
    like = ssalb_unscaled
    w = torch.as_tensor(tab.w, dtype=like.dtype, device=like.device)
    mu = torch.as_tensor(tab.mu, dtype=like.dtype, device=like.device)
    wmu = w * mu

    iu = bounds.up[..., 0, :, :]    # azimuth mode 0: [..., L+1, N]
    idn = bounds.dn[..., 0, :, :]
    fup = 2.0 * math.pi * torch.einsum("j,...vj->...v", wmu, iu)
    fdn_diff = 2.0 * math.pi * torch.einsum("j,...vj->...v", wmu, idn)

    beam = torch.where(fbeam > 0.0, fbeam, 0.0)[..., None]
    mu0 = torch.abs(umu0)[..., None]
    fdir_scaled = mu0 * beam * expbea_scaled
    rfldir = mu0 * beam * expbea_true
    rfldn = fdn_diff + fdir_scaled - rfldir
    uavg = (0.5 * torch.einsum("j,...vj->...v", w, iu + idn)
            + beam * expbea_scaled / (4.0 * math.pi))

    # flux divergence: the layer below each boundary (last level: layer L-1)
    ssl = torch.cat([ssalb_unscaled, ssalb_unscaled[..., -1:]], dim=-1)
    src = uavg if b_level is None else uavg - b_level
    dfdt = 4.0 * math.pi * (1.0 - ssl) * src
    return FluxFields(rfldir, rfldn, fup, dfdt, uavg)
