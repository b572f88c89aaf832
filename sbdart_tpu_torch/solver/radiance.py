"""User-angle radiance helpers of the lane radiance path (torch port of the
part of sbdart_tpu/solver/radiance.py that solver/radlane.py imports):
the analytic per-layer path integrals and the Nakajima-Tanaka TMS and IMS
single-scatter corrections (disort.f:INTCOR/SECSCA).

The reference's `jax.lax.scan` over layers becomes a Python loop over
layers on [..., U, P] tensors carrying the same recursion.  User angles
are static host numbers.  The generic path's `compute_radiances` comes
with that path (ROADMAP Queue A item 7).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sbdart_tpu_torch.solver.deltam import DeltaMResult

RES_EPS = 1e-5   # resonance half-width for the Taylor switchover


def _int_toward(k, delta, u):
    """int_0^D e^{-k t'} e^{-t'/u} dt' / u  (decay toward the path start)."""
    return (1.0 - torch.exp(-(k + 1.0 / u) * delta)) / (u * k + 1.0)


def _int_away(k, delta, u):
    """int_0^D e^{-k (D - t')} e^{-t'/u} dt' / u, resonance-safe: as
    u k -> 1 the closed form (E - e^{-kD}) / (u k - 1), E = e^{-D/u}, is
    replaced by its Taylor form about E D / u."""
    e_u = torch.exp(-delta / u)
    d = u * k - 1.0
    safe_d = torch.where(torch.abs(d) < RES_EPS, 1.0, d)
    exact = (e_u - torch.exp(-k * delta)) / safe_d
    taylor = e_u * (delta / u) * (1.0 - d * delta / (2.0 * u))
    return torch.where(torch.abs(d) < RES_EPS, taylor, exact)


def _legendre_at(x: torch.Tensor, nmom: int) -> torch.Tensor:
    """P_l(x) for l = 0..nmom-1 stacked on a new leading axis."""
    p0 = torch.ones_like(x)
    if nmom == 1:
        return p0[None]
    p1 = x
    out = [p0, p1]
    for l in range(1, nmom - 1):
        p2 = ((2 * l + 1) * x * p1 - l * p0) / (l + 1)
        p0, p1 = p1, p2
        out.append(p2)
    return torch.stack(out, dim=0)


def _cos_scattering_angle(mu0, phi0, umu, phi, like):
    """cos of the scattering angle between the beam and each view,
    [..., U, P]."""
    umu_j = torch.as_tensor(umu, dtype=like.dtype, device=like.device)
    phi_r = torch.as_tensor(np.deg2rad(phi), dtype=like.dtype,
                            device=like.device)
    su = torch.sqrt(torch.clamp(1.0 - umu_j**2, 0.0, 1.0))
    s0 = torch.sqrt(torch.clamp(1.0 - mu0**2, 0.0, 1.0))
    return (
        -mu0[..., None, None] * umu_j[:, None]
        + s0[..., None, None] * su[:, None]
        * torch.cos(torch.deg2rad(phi0)[..., None, None] - phi_r[None, :])
    )


def _cumsum0(x, dim=-1):
    """Cumulative sum with a leading zero along `dim`."""
    c = torch.cumsum(x, dim=dim)
    zero = torch.zeros_like(c.narrow(dim, 0, 1))
    return torch.cat([zero, c], dim=dim)


def _tms_correction(*, dm: DeltaMResult, pmom_unscaled, expbea_s, fbeam,
                    mu0, phi0, umu: np.ndarray, phi: np.ndarray,
                    nstr: int) -> torch.Tensor:
    """Nakajima-Tanaka TMS: replace the truncated single-scatter radiance
    with the exact-phase single-scatter radiance (both with delta-M scaled
    attenuation).  Returns duu[..., L+1, U, P]."""
    like = dm.dtau
    nmom = pmom_unscaled.shape[-1]
    pl = _legendre_at(_cos_scattering_angle(mu0, phi0, umu, phi, like), nmom)
    twol1_full = torch.as_tensor(2.0 * np.arange(nmom) + 1.0,
                                 dtype=like.dtype, device=like.device)

    # exact phase / (1-f) minus the truncated scaled phase, per layer
    f = dm.f[..., None]                                   # [..., L, 1]
    coef_ex = twol1_full * pmom_unscaled / (1.0 - f)      # [..., L, lmax]
    coef_tr = torch.zeros_like(coef_ex)
    coef_tr[..., :nstr] = twol1_full[:nstr] * dm.gl
    dcoef = coef_ex - coef_tr
    # dP[..., L, U, P] = sum_l dcoef_l P_l(cosang)
    dphase = torch.einsum("...Ll,...upl->...Lup", dcoef,
                          torch.movedim(pl, 0, -1))

    w0s = dm.ssalb[..., None, None]
    amp = torch.where(fbeam > 0, fbeam, 0.0)[..., None, None, None] \
        / (4.0 * math.pi)
    src = amp * w0s * dphase                              # [..., L, U, P]

    dtau_b = dm.dtau[..., None, None]
    eb_top = expbea_s[..., :-1, None, None]
    inv_mu0 = (1.0 / mu0)[..., None, None, None]
    nlyr = dm.dtau.shape[-1]
    out = torch.zeros(src.shape[:-3] + (nlyr + 1, len(umu), len(phi)),
                      dtype=like.dtype, device=like.device)

    def recursion(idx, downward: bool):
        u_abs = torch.as_tensor(np.abs(umu[idx]), dtype=like.dtype,
                                device=like.device)
        ub = u_abs[:, None]                               # [U, 1(P)]
        e_lay = torch.exp(-dtau_b / ub)                   # [..., L, U, 1]
        integ = (_int_away(inv_mu0, dtau_b, ub) if downward
                 else _int_toward(inv_mu0, dtau_b, ub))
        j_lay = src[..., idx, :] * eb_top * integ         # [..., L, U, P]
        e_lay = e_lay * torch.ones_like(j_lay)
        acc = torch.zeros(j_lay.shape[:-3] + j_lay.shape[-2:],
                          dtype=like.dtype, device=like.device)
        bounds = [None] * (nlyr + 1)
        order = range(nlyr) if downward else range(nlyr - 1, -1, -1)
        bounds[0 if downward else nlyr] = acc
        for l in order:
            acc = acc * e_lay[..., l, :, :] + j_lay[..., l, :, :]
            bounds[l + 1 if downward else l] = acc
        return torch.stack(bounds, dim=-3)

    up_idx = np.where(umu > 0)[0]
    dn_idx = np.where(umu < 0)[0]
    if len(up_idx) > 0:
        out[..., up_idx, :] = recursion(up_idx, downward=False)
    if len(dn_idx) > 0:
        out[..., dn_idx, :] = recursion(dn_idx, downward=True)
    return out


def xi_function(u1, u2, u3, tau):
    """Chi function of secondary scattering (disort.f:XIFUNC, STWL eq. 72),
    specialised to the IMS use u2 == u3 (the only call site),
    resonance-safe:

        Xi(u1, u2, u2, tau) = ((tau - 1/x1) e^{-tau/u2} + e^{-tau/u1}/x1)
                              / (x1 u1 u2),   x1 = 1/u1 - 1/u2,

    with the u1 -> u2 limit tau^2 e^{-tau/u1} / (2 u1 u2)."""
    del u3
    x1 = 1.0 / u1 - 1.0 / u2
    near = torch.abs(x1 * torch.maximum(u1, u2)) < 1e-4
    safe_x1 = torch.where(near, 1.0, x1)
    e1 = torch.exp(-tau / u1)
    e2 = torch.exp(-tau / u2)
    exact = ((tau - 1.0 / safe_x1) * e2 + e1 / safe_x1) / (safe_x1 * u1 * u2)
    # Taylor in x1 about 0: tau^2 e1 / (2 u1 u2) * (1 - tau x1 / 3)
    taylor = tau * tau * e1 / (2.0 * u1 * u2) * (1.0 - tau * x1 / 3.0)
    return torch.where(near, taylor, exact)


def _ims_correction(*, dm: DeltaMResult, pmom_unscaled, ssalb_unscaled,
                    tau_u, fbeam, mu0, phi0, umu: np.ndarray,
                    phi: np.ndarray, nstr: int) -> torch.Tensor:
    """Nakajima-Tanaka IMS secondary-scattering correction (disort.f:
    SECSCA, STWL eq. A7/A13), to be SUBTRACTED from uu: zero at
    upward-viewing angles.  All quantities use the UNSCALED optical
    properties, averaged from the top down to each output boundary, as the
    reference does.  Returns duu[..., L+1, U, P]."""
    like = dm.dtau
    nmom = pmom_unscaled.shape[-1]
    umu_j = torch.as_tensor(umu, dtype=like.dtype, device=like.device)
    pl = _legendre_at(_cos_scattering_angle(mu0, phi0, umu, phi, like), nmom)
    twol1_full = torch.as_tensor(2.0 * np.arange(nmom) + 1.0,
                                 dtype=like.dtype, device=like.device)

    w = ssalb_unscaled
    dt = dm.dtau_unscaled
    wbar_c = _cumsum0(w * dt)                            # [..., L+1]
    fbar_c = _cumsum0(w * dm.f * dt)
    stau = tau_u                                         # [..., L+1]
    tiny = 1e-30
    fbar = fbar_c / torch.clamp_min(wbar_c, tiny)
    wbar = wbar_c / torch.clamp_min(stau, tiny)
    fw = torch.clamp(fbar * wbar, 0.0, 1.0 - 1e-6)

    # layer-averaged spike moments gbar_K for K >= nstr (gbar = 1 below)
    gbar_c = _cumsum0(pmom_unscaled * (w * dt)[..., None], dim=-2)
    denom = torch.clamp_min(fbar_c, tiny)[..., None]
    gbar = torch.clamp(gbar_c / denom, 0.0, 1.0)
    kmask = torch.as_tensor(np.arange(nmom) >= nstr, device=like.device)
    gfac = torch.where(kmask, 2.0 * gbar - gbar * gbar, 1.0)

    # pspike[..., v, U, P] = sum_K gfac_K (2K+1) P_K(cosang)
    pspike = torch.einsum("...vl,...upl->...vup", gfac * twol1_full,
                          torch.movedim(pl, 0, -1))

    umu0p = mu0[..., None] / (1.0 - fw)                  # [..., L+1]
    dn = umu_j < 0
    u1 = torch.where(dn, -umu_j, 1.0)                    # [U]
    xi = xi_function(u1[:, None], umu0p[..., None, None],
                     umu0p[..., None, None], stau[..., None, None])

    amp = (
        torch.where(fbeam > 1e-4, fbeam, 0.0)[..., None, None, None]
        / (4.0 * math.pi)
        * (fw * fw / torch.clamp_min(1.0 - fw, 1e-6))[..., None, None]
    )
    ok = ((wbar_c > 1e-4) & (fbar_c > 1e-4) & (stau > 1e-4))[..., None, None]
    return torch.where(ok & dn[:, None], amp * pspike * xi, 0.0)
