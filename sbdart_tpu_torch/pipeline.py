"""The spectral pipeline: SBDART's outer wavelength x k-distribution loop
(torch port of sbdart_tpu/pipeline.py).

The full spectral grid is built up front (optics.build_optical_deck) and
moved to the device once; it is then solved in fixed-size wavelength
CHUNKS, each ONE batched solve over the (chunk, k) axes.  k-weighting and
spectral integration happen on the host (outputs.py) where they are cheap.

This slice runs solar-only spectra.  A run whose thermal mask turns the
Planck source on (any sample beyond THERMAL_WL_UM under the default
nothrm = -1, or nothrm = 0) raises NotImplementedError rather than
dropping the source.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sbdart_tpu_torch.atmosphere import Profile, build_profile
from sbdart_tpu_torch.clouds import apply_cloud_humidity, load_usrcld_dat
from sbdart_tpu_torch.config import Config
from sbdart_tpu_torch.convert import deck_to_torch
from sbdart_tpu_torch.dtypes import default_device, default_dtype, parse_dtype
from sbdart_tpu_torch.optics import build_optical_deck
from sbdart_tpu_torch.solar import (
    filter_function,
    solar_geometry,
    solar_irradiance,
    spectral_grid,
)
from sbdart_tpu_torch.solver.disort import solve_rte, unsupported
from sbdart_tpu_torch.surface import surface_albedo

THERMAL_WL_UM = 2.0     # nothrm = -1: thermal source on beyond this (rt.doc)
DEFAULT_CHUNK = 48


@dataclasses.dataclass
class SpectralResult:
    """Per-wavelength, level-resolved results (spectral densities, per um)."""
    cfg: Config
    profile: Profile
    wl: np.ndarray            # [nwl]
    dwl: np.ndarray           # [nwl] trapezoid integration weights
    fbeam_toa: np.ndarray     # [nwl] filtered solar irradiance W/m^2/um
    filt: np.ndarray          # [nwl]
    csza: float
    fdir: np.ndarray          # [nwl, nlev]
    fdn: np.ndarray           # [nwl, nlev] diffuse down
    fup: np.ndarray           # [nwl, nlev]
    dfdt: np.ndarray          # [nwl, nlev]
    uavg: np.ndarray          # [nwl, nlev]
    uu: np.ndarray | None     # [nwl, nlev, nzen, nphi]
    umu: np.ndarray | None
    phi: np.ndarray | None

    @property
    def nlev(self) -> int:
        return self.profile.nlev

    def level_index(self, z_km: float) -> int:
        return int(np.argmin(np.abs(self.profile.z - z_km)))


def _trapz_weights(wl: np.ndarray) -> np.ndarray:
    if len(wl) == 1:
        return np.ones(1)
    w = np.zeros_like(wl)
    d = np.diff(wl)
    w[0] = d[0] / 2
    w[-1] = d[-1] / 2
    w[1:-1] = (d[:-1] + d[1:]) / 2
    return w


def thermal_mask(cfg: Config, wl: np.ndarray) -> np.ndarray:
    """Per-sample Planck-source switch (pipeline.py:245-252)."""
    if cfg.nothrm == 0:
        return np.ones(len(wl), bool)
    if cfg.nothrm == 1:
        return np.zeros(len(wl), bool)
    return wl > THERMAL_WL_UM


def run_albtrn(cfg: Config, *args, **kw):
    """The ibcnd=1 albedo/transmissivity mode is not ported yet."""
    raise NotImplementedError(
        "ibcnd=1 (run_albtrn, disort.f:ALBTRN) is not ported yet: ROADMAP "
        "Queue A item 10, the ibcnd=1 slice"
    )


def run_pipeline(
    cfg: Config,
    profile: Profile | None = None,
    chunk: int = DEFAULT_CHUNK,
    dtype=None,
    usrcld: np.ndarray | None = None,
    aer_table=None,
    albedo_table=None,
    solar_user=None,
    filter_user=None,
    device=None,
) -> SpectralResult:
    """Run the full spectral pipeline for one configuration/column."""
    if cfg.ibcnd == 1:
        raise ValueError(
            "ibcnd=1 is the albedo/transmission special mode: call "
            "run_albtrn(cfg) (the CLI dispatches automatically)"
        )
    device = default_device() if device is None else torch.device(device)
    if dtype is None:
        dtype = parse_dtype(cfg.dtype) if cfg.dtype else default_dtype(device)
    dtype = parse_dtype(dtype)

    wl = spectral_grid(cfg)
    nwl = len(wl)
    nzen = int(cfg.nzen)
    want_rad = cfg.iout in (5, 6, 20, 21, 22, 23) and nzen > 0
    thermal = thermal_mask(cfg, wl)
    why = unsupported(nstr=cfg.nstr, planck=bool(thermal.any()),
                      onlyfl=not want_rad, brdf=None)
    if why is not None:
        raise NotImplementedError(
            f"sbdart_tpu_torch.run_pipeline does not port {why} yet"
        )

    if profile is None:
        profile = build_profile(cfg)
    profile = apply_cloud_humidity(profile, cfg)
    if cfg.tcloud[0] < 0 and usrcld is None:
        usrcld = load_usrcld_dat("usrcld.dat", profile.nlyr)
    nlyr = profile.nlyr

    nmom = cfg.nstr + 1
    deck = build_optical_deck(profile, cfg, wl, nmom, usrcld, aer_table)

    # solar + surface spectra
    csza, solfac = solar_geometry(cfg)
    if cfg.nf == -1:
        if solar_user is None:
            d = np.loadtxt("solar.dat")
            solar_user = (d[:, 0], d[:, 1])
        e0 = np.interp(wl, solar_user[0], solar_user[1])
    else:
        e0 = solar_irradiance(wl, cfg.nf)
    filt = filter_function(cfg, wl, filter_user)
    fbeam = e0 * solfac                    # W/m^2/um at TOA
    alb = surface_albedo(cfg, wl, albedo_table)

    # the whole spectral problem goes to the device once
    dev_deck = deck_to_torch(deck, device, dtype)
    fbeam_d = torch.as_tensor(fbeam * (csza > 0), dtype=dtype, device=device)
    alb_d = torch.as_tensor(alb, dtype=dtype, device=device)

    nlev = nlyr + 1
    fdir = np.zeros((nwl, nlev))
    fdn = np.zeros((nwl, nlev))
    fup = np.zeros((nwl, nlev))
    dfdt = np.zeros((nwl, nlev))
    uavg = np.zeros((nwl, nlev))

    nchunk = -(-nwl // chunk)
    for ci in range(nchunk):
        s = ci * chunk
        e = min(s + chunk, nwl)
        idx = np.arange(s, e)
        if len(idx) < chunk:  # pad to keep one batch shape
            idx = np.concatenate([idx, np.full(chunk - len(idx), nwl - 1)])
        idx_d = torch.as_tensor(idx, device=device)

        out = solve_rte(
            dev_deck.dtau[idx_d],
            dev_deck.ssalb[idx_d],
            dev_deck.pmom[idx_d][:, None],
            nstr=cfg.nstr,
            fbeam=fbeam_d[idx_d][:, None],
            umu0=csza,
            phi0=cfg.phi0,
            fisot=cfg.fisot,
            albedo=alb_d[idx_d][:, None],
            deltam=cfg.deltam,
            onlyfl=True,
            corint=cfg.corint,
            dtype=dtype,
            device=device,
        )

        wk = deck.wk[idx]                  # [chunk, nk]

        def acc(dst, field):
            v = field.cpu().numpy()        # [chunk, nk, nlev(+powder)]
            v = np.einsum("ck,ckv->cv", wk, v)
            dst[s:e] = v[: e - s, :nlev]

        acc(fdir, out.rfldir)
        acc(fdn, out.rfldn)
        acc(fup, out.flup)
        acc(dfdt, out.dfdt)
        acc(uavg, out.uavg)

    return SpectralResult(
        cfg=cfg, profile=profile, wl=wl, dwl=_trapz_weights(wl),
        fbeam_toa=fbeam * filt, filt=filt, csza=csza,
        fdir=fdir, fdn=fdn, fup=fup, dfdt=dfdt, uavg=uavg,
        uu=None, umu=None, phi=None,
    )
