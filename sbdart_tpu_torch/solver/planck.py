"""Band-averaged and total Planck functions (torch port of
sbdart_tpu/solver/planck.py; disort.f:PLKAVG).

    B(T; nu1, nu2) = integral_{nu1}^{nu2} B_nu(T) d nu    [W m^-2 sr^-1]

The reference's split: a power series of int_0^x t^3/(e^t - 1) dt for
small x = c2 nu / T and an exponential series of the complementary
integral for large x, both evaluated and `where`-selected, so the call is
branchless over (level, band) tensors.  Integer powers are written as the
products XLA's integer_pow forms (x^3 = x (x x), x^4 = (x x)(x x)), so
both packages round alike.
"""

from __future__ import annotations

import math

import torch

from sbdart_tpu_torch.constants import C2_RADIATION, STEFAN_BOLTZMANN
from sbdart_tpu_torch.dtypes import default_device

_PI4_15 = 15.0 / math.pi**4
# Series int_0^x t^3/(e^t-1) dt = x^3 * sum_k a_k x^k  (Bernoulli expansion)
_POW_COEF = (1.0 / 3.0, -1.0 / 8.0, 1.0 / 60.0, 0.0, -1.0 / 5040.0, 0.0,
             1.0 / 272160.0, 0.0, -1.0 / 13305600.0)
_XCUT = 1.0          # series switch point (both accurate to ~1e-9 there)
_NEXP_TERMS = 16     # exp-series terms; tail at x=1 ~ e^-17, negligible


def _cum_fraction(x: torch.Tensor) -> torch.Tensor:
    """F(0->x) = (15/pi^4) * int_0^x t^3/(e^t-1) dt, in [0, 1]."""
    xs = torch.clamp_max(x, _XCUT)    # keep the power series in its domain
    p = torch.zeros_like(xs)
    for k in reversed(range(len(_POW_COEF))):
        p = p * xs + _POW_COEF[k]
    lo = _PI4_15 * (xs * (xs * xs)) * p
    xl = torch.clamp_min(x, _XCUT)
    xl2 = xl * xl
    xl3 = xl * xl2
    s = torch.zeros_like(xl)
    for n in range(1, _NEXP_TERMS + 1):
        s = s + torch.exp(-n * xl) * (
            xl3 / n + 3.0 * xl2 / n**2 + 6.0 * xl / n**3 + 6.0 / n**4
        )
    hi = 1.0 - _PI4_15 * s
    return torch.where(x <= _XCUT, lo, hi)


def planck_band(wvnlo, wvnhi, temp, dtype=torch.float64) -> torch.Tensor:
    """Planck radiance integrated over [wvnlo, wvnhi] cm^-1 at temp K, in
    `dtype` (float64 by default; the f32 flux path evaluates in float32,
    as the reference's does).  Tensor arguments broadcast together and set
    the device."""
    dev = next((a.device for a in (temp, wvnlo, wvnhi)
                if isinstance(a, torch.Tensor)), None)
    wvnlo, wvnhi, t = (torch.as_tensor(a, dtype=dtype, device=dev)
                       for a in (wvnlo, wvnhi, temp))
    t = torch.clamp_min(t, 1e-6)
    x1 = C2_RADIATION * wvnlo / t
    x2 = C2_RADIATION * wvnhi / t
    frac = _cum_fraction(x2) - _cum_fraction(x1)
    t2 = t * t
    return (STEFAN_BOLTZMANN / math.pi) * (t2 * t2) * frac


def planck_total(temp) -> torch.Tensor:
    """sigma T^4 / pi, the full-spectrum Planck radiance, in float64.  A
    tensor argument sets the device; any other goes to
    `dtypes.default_device()`."""
    dev = temp.device if isinstance(temp, torch.Tensor) else default_device()
    t = torch.as_tensor(temp, dtype=torch.float64, device=dev)
    t2 = t * t
    return (STEFAN_BOLTZMANN / math.pi) * (t2 * t2)
