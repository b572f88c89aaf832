"""User-angle radiances (torch port of sbdart_tpu/solver/radiance.py;
disort.f:USRINT/CMPINT and the Nakajima-Tanaka TMS/IMS corrections of
INTCOR/SECSCA): the analytic per-layer path integrals, the generic path's
`compute_radiances`, and the TMS and IMS corrections, which the lane
radiance path (solver/radlane.py) shares.

The DOM solution defines a closed-form source per layer (sums of
exponentials from the eigenmodes, the beam term, a thermal term linear in
optical depth), so the radiance at a view cosine u is an exact path
integral per layer.  The reference's `jax.lax.scan` over layers becomes a
Python loop over layers carrying the same recursion.  User angles are
static host numbers.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sbdart_tpu_torch.constants import slope_tau_floor
from sbdart_tpu_torch.solver.deltam import DeltaMResult
from sbdart_tpu_torch.solver.legendre import legendre_assoc_norm

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


def _recursion(j_lay, e_lay, start, downward: bool):
    """Radiances at every level [..., L+1, U] of the layer recursion
    I_next = I e_l + j_l over j_lay/e_lay [..., L, U]: from the top
    (`downward`) or from the surface, starting at `start` [..., U]."""
    nlyr = j_lay.shape[-2]
    e_lay = e_lay.expand(j_lay.shape)
    carry = start
    levels = [carry]
    order = range(nlyr) if downward else range(nlyr - 1, -1, -1)
    for l in order:
        carry = carry * e_lay[..., l, :] + j_lay[..., l, :]
        levels.append(carry)
    if not downward:
        levels.reverse()
    return torch.stack(levels, dim=-2)


def compute_radiances(*, eig, sol, beam, thermal, dm: DeltaMResult, tau_u,
                      ssalb_unscaled, expbea_s, tab, fbeam, mu0, phi0, fisot,
                      albedo, top_emission, surf_emission, bounds,
                      pmom_unscaled, umu: np.ndarray, phi: np.ndarray,
                      corint: bool, brdf=None) -> torch.Tensor:
    """Radiances uu [..., L+1, U, P] at every layer boundary, for all
    azimuth modes of the generic path (radiance.py:55-326): the source
    projections at the user cosines, the per-layer path integrals, the
    up (from the surface start) and down (from the top illumination)
    recursions per mode, the azimuth sum, and TMS/IMS when `corint`.
    `brdf` None is a Lambertian surface of `albedo`."""
    umu = np.asarray(umu, np.float64)
    phi = np.asarray(phi, np.float64)
    if np.any(umu == 0.0):
        raise ValueError("user view cosines must be nonzero")
    like = dm.dtau
    dtype, device = like.dtype, like.device

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    nmode = eig.kk.shape[-3]
    nstr = tab.ylm.shape[1]
    w = t(tab.w)
    parity = t(tab.parity)
    ylm_u = t(legendre_assoc_norm(umu, nstr, nmode))        # [m, l, U]
    c = 0.5 * dm.ssalb[..., None] * t(tab.twol1) * dm.gl    # [..., L, l]
    cm = c[..., None, :, :]                                 # [..., 1, L, l]

    # ---- source-projection moments ----------------------------------------
    wy = t(tab.ylm) * w[None, None, :]                      # [m, l, i]
    wyp = parity[:, :, None] * wy
    chi_dn = (torch.einsum("mli,...mLij->...mLlj", wy, eig.gp)
              + torch.einsum("mli,...mLij->...mLlj", wyp, eig.gm))
    chi_up = (torch.einsum("mli,...mLij->...mLlj", wy, eig.gm)
              + torch.einsum("mli,...mLij->...mLlj", wyp, eig.gp))
    chi_z = (torch.einsum("mli,...mLi->...mLl", wy, beam.zp)
             + torch.einsum("mli,...mLi->...mLl", wyp, beam.zm))
    # source amplitude at the user angles: s = sum_l c_l Lam_l(u) chi_l
    sd = torch.einsum("...mLl,mlu,...mLlj->...mLuj", cm, ylm_u, chi_dn)
    su = torch.einsum("...mLl,mlu,...mLlj->...mLuj", cm, ylm_u, chi_up)
    sz = torch.einsum("...mLl,mlu,...mLl->...mLu", cm, ylm_u, chi_z)

    # direct-beam pseudo source at the user angles
    from sbdart_tpu_torch.solver.sources import _ylm_at

    ylm0_down = _ylm_at(mu0, nmode, nstr) * parity[:nmode]  # Lam_l^m(-mu0)
    mfac = t(np.where(np.arange(nmode) == 0, 1.0, 2.0))
    x0u = torch.einsum("...mLl,mlu,...ml->...mLu", cm, ylm_u, ylm0_down)
    beam_amp = (torch.where(fbeam > 0, fbeam, 0.0)[..., None, None, None]
                * (mfac[:, None, None] / (2.0 * math.pi)))
    sz_tot = sz + x0u * beam_amp                            # [..., m, L, U]

    mode0_vec = torch.zeros(nmode, dtype=dtype, device=device)
    mode0_vec[0] = 1.0
    # thermal source at the user angles (mode 0 only): st0 + st1 t'
    if thermal is not None:
        chi_y0 = (torch.einsum("li,...Li->...Ll", wy[0], thermal.y0p)
                  + torch.einsum("li,...Li->...Ll", wyp[0], thermal.y0m))
        chi_y1 = (torch.einsum("li,...Li->...Ll", wy[0], thermal.y1p)
                  + torch.einsum("li,...Li->...Ll", wyp[0], thermal.y1m))
        emis = 1.0 - dm.ssalb
        b1 = (thermal.b_bot - thermal.b_top) / torch.clamp_min(
            dm.dtau, slope_tau_floor(dtype))
        st0_0 = (torch.einsum("...Ll,lu,...Ll->...Lu", c, ylm_u[0], chi_y0)
                 + (emis * thermal.b_top)[..., None])
        st1_0 = (torch.einsum("...Ll,lu,...Ll->...Lu", c, ylm_u[0], chi_y1)
                 + (emis * b1)[..., None])
        mode_mask = mode0_vec[:, None, None]
        st0 = mode_mask * st0_0[..., None, :, :]
        st1 = mode_mask * st1_0[..., None, :, :]
    else:
        st0 = torch.zeros(sz_tot.shape, dtype=dtype, device=device)
        st1 = st0

    kk = eig.kk                                       # [..., m, L, N]
    dtau_m = dm.dtau[..., None, :, None]              # [..., 1, L, 1]
    eb_top = expbea_s[..., None, :-1, None]           # [..., 1, L, 1]
    inv_mu0 = (1.0 / mu0)[..., None, None, None]
    wmu_j = t(tab.w * tab.mu)

    def layer_source(idx, int_dn, int_up, int_beam, e_lay, slope):
        return (torch.einsum("...mLj,...mLuj,...mLuj->...mLu", sol.aa,
                             sd[..., idx, :], int_dn)
                + torch.einsum("...mLj,...mLuj,...mLuj->...mLu", sol.bb,
                               su[..., idx, :], int_up)
                + sz_tot[..., idx] * eb_top * int_beam
                + st0[..., idx] * (1.0 - e_lay) + st1[..., idx] * slope)

    def surface_start(u):
        """The upward recursion's start [..., m, U]: the reflected
        downwelling field and direct beam, and the surface emission."""
        fdir_bot = mu0 * torch.where(fbeam > 0, fbeam, 0.0) * expbea_s[..., -1]
        if brdf is None:
            fdn_bot = 2.0 * torch.einsum("j,...j->...", wmu_j,
                                         bounds.dn[..., 0, -1, :])
            i_surf0 = surf_emission + albedo * (fdir_bot / math.pi + fdn_bot)
            return (i_surf0[..., None, None] * mode0_vec[:, None]
                    * torch.ones_like(u))
        from sbdart_tpu_torch.solver.brdf import (
            fourier_refl_matrices,
            hemispherical_reflectance,
        )

        r_user = fourier_refl_matrices(brdf, u, t(tab.mu), nmode)  # [m, U, N]
        refl_diff = torch.einsum("muj,j,...mj->...mu", r_user, wmu_j,
                                 bounds.dn[..., -1, :])
        r_b = fourier_refl_matrices(brdf, u, mu0[..., None],
                                    nmode)[..., :, :, 0]           # [..., m, U]
        refl_beam = (r_b * mfac[:, None] / (2.0 * math.pi)
                     * fdir_bot[..., None, None])
        r_dh_u = hemispherical_reflectance(brdf, u, tab.w, tab.mu)
        bs = surf_emission / torch.clamp_min(1.0 - albedo, 1e-12)
        emis = (1.0 - r_dh_u) * bs[..., None, None] * mode0_vec[:, None]
        return refl_diff + refl_beam + emis

    up_idx = np.where(umu > 0)[0]
    dn_idx = np.where(umu < 0)[0]
    numu = len(umu)
    batchm = torch.broadcast_shapes(sd.shape[:-4], sz_tot.shape[:-3])
    out_parts = torch.zeros(batchm + (nmode, dm.dtau.shape[-1] + 1, numu),
                            dtype=dtype, device=device)
    if len(up_idx):
        # bottom -> top for the positive cosines
        u = t(umu[up_idx])
        ub = u[None, :, None]
        e_lay = torch.exp(-dtau_m / u[None, :])       # [..., 1, L, U]
        j_lay = layer_source(
            up_idx,
            _int_toward(kk[..., None, :], dtau_m[..., None], ub),
            _int_away(kk[..., None, :], dtau_m[..., None], ub),
            _int_toward(inv_mu0[..., None], dtau_m[..., None], ub)[..., 0],
            e_lay, u[None, :] - (dtau_m + u[None, :]) * e_lay)
        out_parts[..., up_idx] = _recursion(j_lay, e_lay, surface_start(u),
                                            downward=False).expand(
            batchm + (nmode, dm.dtau.shape[-1] + 1, len(up_idx)))
    if len(dn_idx):
        # top -> bottom for the negative cosines
        ua = t(np.abs(umu[dn_idx]))
        ub = ua[None, :, None]
        e_lay = torch.exp(-dtau_m / ua[None, :])
        j_lay = layer_source(
            dn_idx,
            _int_away(kk[..., None, :], dtau_m[..., None], ub),
            _int_toward(kk[..., None, :], dtau_m[..., None], ub),
            # the beam along the path: the resonance-safe 'away' integral
            # with k = 1/mu0
            _int_away(inv_mu0[..., None], dtau_m[..., None], ub)[..., 0],
            e_lay, dtau_m - ua[None, :] * (1.0 - e_lay))
        i_top = ((fisot + top_emission)[..., None, None] * mode0_vec[:, None]
                 * torch.ones_like(ua))
        out_parts[..., dn_idx] = _recursion(j_lay, e_lay, i_top,
                                            downward=True).expand(
            batchm + (nmode, dm.dtau.shape[-1] + 1, len(dn_idx)))

    # ---- azimuth assembly ------------------------------------------------
    phi_r = t(np.deg2rad(phi))                              # [P]
    marange = torch.arange(nmode, dtype=dtype, device=device)
    cosm = torch.cos(marange[:, None]
                     * (torch.deg2rad(phi0)[..., None, None] - phi_r))
    uu = torch.einsum("...mvu,...mp->...vup", out_parts, cosm)

    if corint:
        uu = uu + _tms_correction(
            dm=dm, pmom_unscaled=pmom_unscaled, expbea_s=expbea_s,
            fbeam=fbeam, mu0=mu0, phi0=phi0, umu=umu, phi=phi, nstr=nstr)
        if np.any(umu < 0):
            uu = uu - _ims_correction(
                dm=dm, pmom_unscaled=pmom_unscaled,
                ssalb_unscaled=ssalb_unscaled, tau_u=tau_u, fbeam=fbeam,
                mu0=mu0, phi0=phi0, umu=umu, phi=phi, nstr=nstr)
    return uu


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
