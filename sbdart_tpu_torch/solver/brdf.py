"""Bidirectional surface reflectance, the non-Lambertian lower boundary
(torch port of sbdart_tpu/solver/brdf.py; disort.f:SURFAC/BDREF/DREF, the
`lamber = .false.` path).

The DOM needs the azimuth Fourier components of the BRDF on the
quadrature grid,

    R_m(mu_i, mu_j) = int_0^{2pi} rho(mu_i, mu_j, psi) cos(m psi) dpsi

(so the Lambertian rho = alb/pi gives R_0 = 2 alb and R_{m>0} = 0), taken
by the same fixed N_PSI-point trapezoid as the reference.  Models:
`HapkeBrdf` (Hapke 1981, DISORT 2.0's BDREF example) and `RpvBrdf`
(Rahman-Pinty-Verstraete 1993).  Their parameters are Python numbers or
tensors that broadcast with the angles; `convert.brdf_to_torch` carries a
reference model's parameters across.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

N_PSI = 64   # azimuth quadrature points for the Fourier projection


def _sqrt(x):
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else math.sqrt(x)


@dataclasses.dataclass(frozen=True)
class HapkeBrdf:
    """Hapke (1981) BRDF: h-function multiple scattering + hotspot.

    b0: hotspot amplitude, hh: hotspot angular width, w: single-scatter
    albedo of the surface particles (DISORT's BDREF defaults)."""
    b0: float = 1.0
    hh: float = 0.06
    w: float = 0.6

    def rho(self, mu_out, mu_in, cos_dphi):
        mu = torch.abs(mu_out)
        mup = torch.abs(mu_in)
        s = torch.sqrt(torch.clamp(1 - mu**2, 0, 1))
        sp = torch.sqrt(torch.clamp(1 - mup**2, 0, 1))
        # cos of the phase angle between incident and reflected
        calpha = -(-mu * mup + s * sp * cos_dphi)
        calpha = torch.clamp(calpha, -1.0, 1.0)
        alpha = torch.arccos(calpha)
        p = 1.0 + 0.5 * calpha                     # particle phase function
        b = self.b0 * self.hh / (self.hh + torch.tan(alpha / 2.0))
        gamma = _sqrt(1.0 - self.w)

        def h(x):
            return (1.0 + 2.0 * x) / (1.0 + 2.0 * x * gamma)

        return (
            self.w / (4.0 * math.pi) / (mu + mup)
            * ((1.0 + b) * p + h(mu) * h(mup) - 1.0)
        )


@dataclasses.dataclass(frozen=True)
class RpvBrdf:
    """Rahman-Pinty-Verstraete (1993) BRDF."""
    rho0: float = 0.1
    k: float = 0.75
    theta: float = -0.1   # HG asymmetry of the surface phase function

    def rho(self, mu_out, mu_in, cos_dphi):
        mu = torch.abs(mu_out)
        mup = torch.abs(mu_in)
        s = torch.sqrt(torch.clamp(1 - mu**2, 0, 1))
        sp = torch.sqrt(torch.clamp(1 - mup**2, 0, 1))
        cg = -mu * mup + s * sp * cos_dphi         # cos(scatter angle)
        g = self.theta
        fhg = (1 - g**2) / torch.clamp_min(
            (1 + g**2 + 2 * g * cg) ** 1.5, 1e-9)
        tanth = s / torch.clamp_min(mu, 1e-6)
        tanthp = sp / torch.clamp_min(mup, 1e-6)
        bigg = torch.sqrt(torch.clamp_min(
            tanth**2 + tanthp**2 - 2 * tanth * tanthp * cos_dphi, 0.0))
        hot = 1.0 + (1.0 - self.rho0) / (1.0 + bigg)
        m = (mu * mup * (mu + mup)) ** (self.k - 1.0)
        return self.rho0 * m * fhg * hot / math.pi


def fourier_refl_matrices(brdf, mu_out, mu_in, nmode: int):
    """R_m(mu_out_i, mu_in_j): [..., nmode, I, J] by the psi trapezoid.

    mu_in: a tensor whose last axis is J (leading axes broadcast, e.g. the
    per-column beam cosine); mu_out: I cosines, taken to mu_in's dtype and
    device."""
    psi = np.linspace(0.0, 2.0 * np.pi, N_PSI, endpoint=False)

    def t(x):
        return torch.as_tensor(x, dtype=mu_in.dtype, device=mu_in.device)

    cosm = t(np.cos(np.arange(nmode)[:, None] * psi[None, :]))   # [m, P]
    rho = brdf.rho(t(mu_out)[..., :, None, None], mu_in[..., None, :, None],
                   t(np.cos(psi)))                               # [..., I, J, P]
    dpsi = 2.0 * np.pi / N_PSI
    return torch.einsum("...ijp,mp->...mij", rho, cosm) * dpsi


def hemispherical_reflectance(brdf, mu_in, w, mu):
    """Directional-hemispherical albedo r_dh(mu_in_j) (DREF): 1 - r_dh is
    the directional emissivity of the surface.  mu_in: a tensor of
    cosines; w, mu: the quadrature."""
    r0 = fourier_refl_matrices(brdf, np.asarray(mu), mu_in, 1)
    wmu = torch.as_tensor(np.asarray(w) * np.asarray(mu), dtype=mu_in.dtype,
                          device=mu_in.device)
    return torch.einsum("i,...ij->...j", wmu, r0[..., 0, :, :])
