"""The reference of a batch of perturbed columns: the spectrally
integrated fluxes fdir, fdn, fup [C, nlev] of the columns the caller
names, from the namelist text and the columns' scalings alone.  The
nominal column's set-up is worked out again by the frozen copies beside
this file, each column's optics recombined from it as the program's
sbdart_tpu_torch/batch.py:build_batch_fn did when this benchmark was
written (gas k-terms scaled by the gas scale, cloud and aerosol optical
depth and scattering by their burdens, the albedo clipped to [0, 1]),
solved by `solve.solve` and integrated with the filter-weighted
trapezoid weights.  Later PRs do not edit this file.
"""

from __future__ import annotations

import numpy as np
import torch

from rtbench.reference.aerosols import aerosol_optical_properties
from rtbench.reference.atmosphere import build_profile
from rtbench.reference.clouds import (
    apply_cloud_humidity,
    cloud_mie_moments,
    cloud_optical_properties,
)
from rtbench.reference.namelist import loads_namelist
from rtbench.reference.optics import build_optical_deck, component_moments
from rtbench.reference.spectral import (
    band_edges_wavenumber,
    thermal_mask,
    trapz_weights,
)
from rtbench.reference.rayleigh import rayleigh_moments
from rtbench.reference.solar import (
    filter_function,
    solar_irradiance,
    spectral_grid,
)
from rtbench.reference.solve import solve
from rtbench.reference.surface import surface_albedo

NAMES = ("csza", "gas_scale", "cld_scale", "aer_scale", "albedo_scale")


def run(text: str, columns: dict, *, dtype, device, band_chunk: int = 128
        ) -> dict:
    """fdir, fdn, fup [C, nlev] (numpy float64) of the columns whose
    parameters `columns` holds (NAMES, each [C])."""
    cfg = loads_namelist(text).validate()
    profile = apply_cloud_humidity(build_profile(cfg), cfg)
    wl = spectral_grid(cfg)
    nmom = cfg.nstr + 1
    deck = build_optical_deck(profile, cfg, wl, nmom)
    e0 = solar_irradiance(wl, cfg.nf)
    w_int = filter_function(cfg, wl) * trapz_weights(wl)
    alb = surface_albedo(cfg, wl)
    thermal = thermal_mask(cfg, wl)
    any_thermal = bool(thermal.any())
    wvnlo, wvnhi = band_edges_wavenumber(wl)
    band_dlam = 1.0e4 / wvnlo - 1.0e4 / wvnhi
    tau_c, w0_c, g_c = cloud_optical_properties(profile, cfg, wl)
    tau_a, w0_a, g_a = aerosol_optical_properties(profile, cfg, wl)
    pmaer = np.asarray([p for p in cfg.pmaer], np.float64)
    if cfg.imomc == 4:
        mom_c = cloud_mie_moments(profile, cfg, wl, nmom)
    else:
        mom_c = component_moments(g_c, cfg.imomc, nmom)
    mom_c = (w0_c * tau_c)[..., None] * mom_c
    mom_a = (w0_a * tau_a)[..., None] * component_moments(
        g_a, cfg.imoma, nmom, user_moments=pmaer if pmaer.size else None)
    mom_r = deck.tau_ray[..., None] * rayleigh_moments(nmom)
    btemp = cfg.btemp if cfg.btemp > 0 else float(profile.t[-1])
    nlev = profile.nlev

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    col = {k: t(columns[k]) for k in NAMES}
    ncol = len(columns["csza"])
    acc = {k: torch.zeros((ncol, nlev), dtype=dtype, device=device)
           for k in ("fdir", "fdn", "fup")}
    for s in range(0, len(wl), band_chunk):
        b = slice(s, min(s + band_chunk, len(wl)))
        gs = col["gas_scale"][:, None, None, None]
        cs = col["cld_scale"][:, None, None, None]
        as_ = col["aer_scale"][:, None, None, None]
        tau_ray = t(deck.tau_ray[b])[None, :, None, :]
        dtau = (tau_ray + gs * t(deck.tau_gas[b])[None]
                + cs * t(tau_c[b])[None, :, None, :]
                + as_ * t(tau_a[b])[None, :, None, :])
        scat = (tau_ray + cs * t(w0_c[b] * tau_c[b])[None, :, None, :]
                + as_ * t(w0_a[b] * tau_a[b])[None, :, None, :])
        ssalb = torch.clip(scat / torch.clamp_min(dtau, 1e-30), 0.0, 1.0)
        mom = (t(mom_r[b])[None, :, None] + cs[..., None] * t(mom_c[b])[
            None, :, None] + as_[..., None] * t(mom_a[b])[None, :, None])
        pmom = mom / torch.clamp_min(scat[..., None], 1e-30)
        pmom[..., 0] = 1.0
        tm = t(thermal[b])[None, :, None] > 0
        fb = t(e0[b] * cfg.solfac)[None, :, None] * torch.where(
            tm, t(band_dlam[b])[None, :, None], 1.0)
        out = solve(
            dtau, ssalb, pmom, nstr=cfg.nstr, fbeam=fb,
            umu0=col["csza"][:, None, None], fisot=cfg.fisot,
            albedo=torch.clip(col["albedo_scale"][:, None, None]
                              * t(alb[b])[None, :, None], 0.0, 1.0),
            planck=any_thermal,
            temper=torch.where(tm[..., None], t(profile.t), 1e-4),
            wvnlo=t(wvnlo[b])[None, :, None], wvnhi=t(wvnhi[b])[None, :, None],
            btemp=torch.where(tm, btemp, 1e-4), deltam=cfg.deltam,
            onlyfl=True, dtype=dtype, device=device)
        conv = torch.where(tm, 1.0 / t(band_dlam[b])[None, :, None], 1.0)
        w = t(w_int[b])[None, :, None] * conv * t(deck.wk[b])[None]
        for k, f in zip(acc, (out.rfldir, out.rfldn, out.flup)):
            acc[k] += torch.einsum("cbk,cbkv->cv", w.expand(ncol, -1, -1),
                                   f)
    return {k: v.double().cpu().numpy() for k, v in acc.items()}
