"""Delta-M scaling of optical properties (torch port of
sbdart_tpu/solver/deltam.py; disort.f:SETDIS, Wiscombe 1977).

    tau* = (1 - w f) tau
    w*   = w (1 - f) / (1 - w f)
    g_l* = (g_l - f) / (1 - f),   l < nstr
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from sbdart_tpu_torch.constants import SSALB_DITHER

F_MAX = 1.0 - 1e-6   # the truncated fraction's clamp


class DeltaMResult(NamedTuple):
    dtau: torch.Tensor    # [..., L]      scaled layer optical depth
    ssalb: torch.Tensor   # [..., L]      scaled single-scatter albedo (dithered)
    gl: torch.Tensor      # [..., L, nstr] scaled moments g_l*, l = 0..nstr-1
    f: torch.Tensor | None  # [..., L]    truncated fraction (None where
                            #               no reader needs it)
    dtau_unscaled: torch.Tensor  # [..., L] original optical depth


def ssalb_dither(dtype: torch.dtype) -> float:
    """Conservative-scattering dither, scaled to precision: the
    eigenproblem is singular at w0 == 1 (disort.f:SETDIS dithers the same
    way)."""
    return max(SSALB_DITHER, 100.0 * float(torch.finfo(dtype).eps))


def apply_deltam(
    dtau: torch.Tensor,
    ssalb: torch.Tensor,
    pmom: torch.Tensor,
    nstr: int,
    deltam: bool = True,
) -> DeltaMResult:
    """Apply delta-M scaling.

    Args:
      dtau: [..., L] layer optical depths.
      ssalb: [..., L] single-scatter albedos in [0, 1].
      pmom: [..., L, nmom] phase moments g_l with pmom[..., 0] == 1.
      nstr: stream count.
      deltam: disable to pass through (reference `deltam` namelist flag).
    """
    nmom = pmom.shape[-1]
    dither = ssalb_dither(ssalb.dtype)
    ssalb = torch.clamp(ssalb, 0.0, 1.0 - dither)
    if not deltam or nmom <= nstr:
        gl = pmom[..., :nstr]
        if gl.shape[-1] < nstr:
            gl = F.pad(gl, (0, nstr - gl.shape[-1]))
        f = torch.zeros_like(dtau)
        return DeltaMResult(dtau, ssalb, gl, f, dtau)

    f = torch.clamp(pmom[..., nstr], 0.0, F_MAX)
    wf = ssalb * f
    dtau_s = (1.0 - wf) * dtau
    ssalb_s = ssalb * (1.0 - f) / (1.0 - wf)
    ssalb_s = torch.clamp(ssalb_s, 0.0, 1.0 - dither)
    gl = (pmom[..., :nstr] - f[..., None]) / (1.0 - f[..., None])
    return DeltaMResult(dtau_s, ssalb_s, gl, f, dtau)
