"""The spectral pipeline: SBDART's outer wavelength x k-distribution loop
(torch port of sbdart_tpu/pipeline.py), fluxes and, for iout 5, 6 and
20-23, radiances at the user angles.

The full spectral grid is built up front (optics.build_optical_deck) and
moved to the device once; it is then solved in fixed-size wavelength
CHUNKS, each ONE batched solve over the (chunk, k) axes.  k-weighting and
spectral integration happen on the host (outputs.py) where they are cheap.

As the reference compiles one chunk solver per static configuration
(`_jitted_solver`, sbdart_tpu/pipeline.py:100-121) and replays it per
chunk, `_captured_solver` keeps one ops/graph.py:CapturedCall per static
configuration, chunk shape and device: the first chunk of a key runs
eagerly (the warm-up; a one-chunk run captures nothing), every later one
is copied into the graph's static inputs and replayed, where
ops/graph.py:graph_ok admits the route (float32 on the card), and runs
eagerly elsewhere.

Thermal handling, as the reference's: when any sample is thermal (beyond
THERMAL_WL_UM under the default nothrm = -1, or every sample under
nothrm = 0), every chunk is solved with the Planck source on and a
per-sample mask folds it away on solar samples (temperatures of 1e-4 K),
so one configuration covers the whole spectrum.  Thermal outputs are
band-integrated, so thermal samples feed the beam as fbeam x band width
and are converted back to per-um densities at the end.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sbdart_tpu_torch.atmosphere import Profile, build_profile
from sbdart_tpu_torch.clouds import apply_cloud_humidity, load_usrcld_dat
from sbdart_tpu_torch.config import Config
from sbdart_tpu_torch.convert import deck_to_torch, rte_inputs_to_torch
from sbdart_tpu_torch.dtypes import default_device, default_dtype, parse_dtype
from sbdart_tpu_torch.ops.graph import (
    CapturedCall,
    as_device,
    graph_cache,
    graph_ok,
)
from sbdart_tpu_torch.optics import build_optical_deck
from sbdart_tpu_torch.solar import (
    filter_function,
    solar_geometry,
    solar_irradiance,
    spectral_grid,
)
from sbdart_tpu_torch.solver.disort import route, solve_rte
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


def band_edges_wavenumber(wl: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-sample wavenumber band edges (midpoints of the wl grid;
    pipeline.py:70-86)."""
    nu = 1.0e4 / wl
    if len(wl) == 1:
        half = 0.5 * max(nu[0] * 1e-3, 1.0)
        return nu - half, nu + half
    mid = 0.5 * (nu[1:] + nu[:-1])
    lo_e = np.empty_like(nu)
    hi_e = np.empty_like(nu)
    hi_e[0] = nu[0] + abs(nu[0] - mid[0])
    lo_e[-1] = nu[-1] - abs(mid[-1] - nu[-1])
    lo_e[:-1] = mid
    hi_e[1:] = mid
    return np.minimum(lo_e, hi_e), np.maximum(lo_e, hi_e)


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


def user_angles(cfg: Config):
    """(umu [nzen], phi [nphi]) of a radiance request (iout 5, 6, 20-23
    with nzen > 0), else (None, None), as the reference's pipeline makes
    them (pipeline.py:211-226): nphi defaults to 1, negative azimuths
    read as 0, and |umu| is clamped to >= 1e-4."""
    nzen = int(cfg.nzen)
    if cfg.iout not in (5, 6, 20, 21, 22, 23) or nzen <= 0:
        return None, None
    nphi = int(cfg.nphi) or 1
    phi = np.array([p if p >= 0 else 0.0 for p in cfg.phi[:nphi]])
    umu = np.cos(np.deg2rad(np.array(cfg.uzen[:nzen], np.float64)))
    return np.where(np.abs(umu) < 1e-4, 1e-4, umu), phi


@graph_cache(maxsize=32)
def _captured_solver(nstr, onlyfl, planck, deltam, corint, numu, nphi,
                     dtype_name, umu, phi, shapes, device) -> CapturedCall:
    """One chunk solver per static configuration: the counterpart of the
    reference's `_jitted_solver` (sbdart_tpu/pipeline.py:100-121), keyed
    by its static arguments, then by its static `umu`/`phi` (tuples of the
    rounded cosines and azimuths; () without radiances), the chunk's
    input shapes ((name, shape) pairs) and the device.  Each graph holds a
    private memory pool until the cache drops it: 32 keys, as the
    reference's, and before a capture the least recently used graphs
    whose pools pass ops/graph.py:pool_budget (graph_cache)."""
    dtype = parse_dtype(dtype_name)

    def solve(dtau, ssalb, pmom, fbeam, umu0, phi0, fisot, albedo,
              temper=None, wvnlo=0.0, wvnhi=0.0, btemp=0.0, ttemp=0.0,
              temis=0.0):
        return solve_rte(
            dtau, ssalb, pmom, nstr=nstr, fbeam=fbeam, umu0=umu0,
            phi0=phi0, fisot=fisot, albedo=albedo, planck=planck,
            temper=temper, wvnlo=wvnlo, wvnhi=wvnhi, btemp=btemp,
            ttemp=ttemp, temis=temis, deltam=deltam, onlyfl=onlyfl,
            umu=np.array(umu) if numu else None,
            phi=np.array(phi) if nphi else None,
            corint=corint, dtype=dtype, device=device,
        )

    path = route(nstr=nstr, onlyfl=onlyfl, brdf=None, umu=umu or None,
                 phi=phi or None)
    return CapturedCall(solve, capture=graph_ok(path, nstr, dtype, device))


def solver_key(cfg: Config, *, onlyfl: bool, planck: bool, umu, phi,
               dtype: torch.dtype, inputs: dict, device) -> tuple:
    """The arguments of `_captured_solver` for a run of `cfg` whose chunks
    have the tensors `inputs`: what the reference's jit treats as static
    (pipeline.py:262-266 and the static umu/phi), never the data."""
    def angles(a):
        return () if a is None else tuple(float(x) for x in np.round(a, 10))

    return (cfg.nstr, onlyfl, planck, cfg.deltam, cfg.corint,
            0 if umu is None else len(umu), 0 if phi is None else len(phi),
            str(dtype).removeprefix("torch."), angles(umu), angles(phi),
            tuple((k, tuple(v.shape)) for k, v in inputs.items()),
            torch.device(device))


@dataclasses.dataclass
class AlbTrnResult:
    """ibcnd=1 (disort.f:ALBTRN) results: slab albedo & transmissivity."""
    cfg: Config
    profile: Profile
    wl: np.ndarray        # [nwl]
    umu: np.ndarray       # [numu] incidence cosines
    albmed: np.ndarray    # [nwl, numu]
    trnmed: np.ndarray    # [nwl, numu]


def run_albtrn(
    cfg: Config,
    profile: Profile | None = None,
    dtype=None,
    usrcld: np.ndarray | None = None,
    aer_table=None,
    eig_method: str = "auto",
    device=None,
) -> AlbTrnResult:
    """The ibcnd=1 special mode: plane albedo / total transmissivity of the
    whole slab per incidence angle (disort.f:ALBTRN/ALTRIN/SPALTR), batched
    over the spectral grid (sbdart_tpu/pipeline.py:124-180).  `eig_method` as in
    solve_rte."""
    from sbdart_tpu_torch.solver.albtrn import slab_albedo_transmission

    device = default_device() if device is None else torch.device(device)
    if dtype is None:
        dtype = parse_dtype(cfg.dtype) if cfg.dtype else default_dtype(device)
    dtype = parse_dtype(dtype)
    if profile is None:
        profile = build_profile(cfg)
    wl = spectral_grid(cfg)
    nzen = int(cfg.nzen)
    if nzen <= 0:
        raise ValueError(
            "ibcnd=1 needs incidence angles: set nzen and uzen (degrees)"
        )
    uzen = np.array(cfg.uzen[:nzen], np.float64)
    umu = np.abs(np.cos(np.deg2rad(uzen)))
    nmom = cfg.nstr + 1
    deck = build_optical_deck(profile, cfg, wl, nmom, usrcld, aer_table)
    # gas k-terms: the weighted-mean optical depth (ALBTRN is a
    # monochromatic slab property; k-weighting the albedo itself would mix
    # nonlinearly), as the reference does
    dtau = np.einsum("wk,wkl->wl", deck.wk, deck.dtau)
    ssalb = np.einsum("wk,wkl->wl", deck.wk, deck.ssalb * deck.dtau) / np.maximum(
        dtau, 1e-30
    )

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    albmed, trnmed = slab_albedo_transmission(
        t(dtau), t(np.clip(ssalb, 0.0, 1.0)), t(deck.pmom),
        nstr=cfg.nstr,
        umu=t(umu),
        albedo=cfg.albcon,
        deltam=cfg.deltam,
        dtype=dtype,
        eig_method=eig_method,
        device=device,
    )
    return AlbTrnResult(
        cfg=cfg, profile=profile, wl=wl, umu=umu,
        albmed=albmed.cpu().numpy(), trnmed=trnmed.cpu().numpy(),
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
    umu, phi = user_angles(cfg)
    want_rad = umu is not None
    thermal = thermal_mask(cfg, wl)
    any_thermal = bool(thermal.any())

    if profile is None:
        profile = build_profile(cfg)
    profile = apply_cloud_humidity(profile, cfg)
    if cfg.tcloud[0] < 0 and usrcld is None:
        usrcld = load_usrcld_dat("usrcld.dat", profile.nlyr)
    nlyr = profile.nlyr

    nmom = max(cfg.nstr + 1, 65) if want_rad else cfg.nstr + 1
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

    wvnlo, wvnhi = band_edges_wavenumber(wl)
    band_dlam = 1.0e4 / wvnlo - 1.0e4 / wvnhi   # band width in um
    temper = profile.t                      # [nlev] TOA-first
    btemp = cfg.btemp if cfg.btemp > 0 else float(temper[-1])
    ttemp = cfg.ttemp if cfg.ttemp > 0 else float(temper[0])
    if cfg.spowder:
        # sub-surface powder slab (optics.py): one extra solver layer at
        # the surface temperature; outputs below the surface are dropped
        temper = np.concatenate([temper, [btemp]])

    # the whole spectral problem goes to the device once
    dev_deck = deck_to_torch(deck, device, dtype)
    alb_d = torch.as_tensor(alb, dtype=dtype, device=device)
    scalars = {k: as_device(v, dtype, device) for k, v in
               (("umu0", csza), ("phi0", cfg.phi0), ("fisot", cfg.fisot))}
    solver = None

    nlev = nlyr + 1
    fdir = np.zeros((nwl, nlev))
    fdn = np.zeros((nwl, nlev))
    fup = np.zeros((nwl, nlev))
    dfdt = np.zeros((nwl, nlev))
    uavg = np.zeros((nwl, nlev))
    uu = np.zeros((nwl, nlev, len(umu), len(phi))) if want_rad else None

    nchunk = -(-nwl // chunk)
    for ci in range(nchunk):
        s = ci * chunk
        e = min(s + chunk, nwl)
        idx = np.arange(s, e)
        if len(idx) < chunk:  # pad to keep one batch shape
            idx = np.concatenate([idx, np.full(chunk - len(idx), nwl - 1)])
        idx_d = torch.as_tensor(idx, device=device)

        # branchless thermal mask: solar samples get temperatures of
        # 1e-4 K (Planck == 0); thermal samples take the beam per band
        tmask = thermal[idx]
        fbeam_c = fbeam[idx] * np.where(tmask, band_dlam[idx], 1.0)
        inputs = dict(
            dtau=dev_deck.dtau[idx_d],
            ssalb=dev_deck.ssalb[idx_d],
            pmom=dev_deck.pmom[idx_d][:, None],
            fbeam=torch.as_tensor(fbeam_c * (csza > 0), dtype=dtype,
                                  device=device)[:, None],
            albedo=alb_d[idx_d][:, None],
            **scalars,
        )
        if any_thermal:
            inputs.update(rte_inputs_to_torch(
                device, dtype,
                temper=np.where(tmask[:, None, None], temper[None, None, :],
                                1e-4),
                wvnlo=wvnlo[idx][:, None], wvnhi=wvnhi[idx][:, None],
                btemp=np.where(tmask, btemp, 1e-4)[:, None],
                ttemp=np.where(tmask, ttemp, 1e-4)[:, None],
                temis=cfg.temis,
            ))
        if solver is None:
            solver = _captured_solver(*solver_key(
                cfg, onlyfl=not want_rad, planck=any_thermal, umu=umu,
                phi=phi, dtype=dtype, inputs=inputs, device=device))
        # a replay's outputs are the graph's: read before the next chunk
        out = solver(inputs)

        wk = deck.wk[idx]                  # [chunk, nk]
        # thermal outputs are per band; convert to per-um spectral density
        conv = np.where(tmask, 1.0 / band_dlam[idx], 1.0)[:, None]

        def acc(dst, field):
            v = field.cpu().numpy()        # [chunk, nk, nlev(+powder)]
            v = np.einsum("ck,ckv->cv", wk, v) * conv
            dst[s:e] = v[: e - s, :nlev]

        acc(fdir, out.rfldir)
        acc(fdn, out.rfldn)
        acc(fup, out.flup)
        acc(dfdt, out.dfdt)
        acc(uavg, out.uavg)
        if want_rad:
            v = out.uu.cpu().numpy()       # [chunk, nk, nlev, numu, nphi]
            v = np.einsum("ck,ckvup->cvup", wk, v) * conv[..., None, None]
            uu[s:e] = v[: e - s, :nlev]

    return SpectralResult(
        cfg=cfg, profile=profile, wl=wl, dwl=_trapz_weights(wl),
        fbeam_toa=fbeam * filt, filt=filt, csza=csza,
        fdir=fdir, fdn=fdn, fup=fup, dfdt=dfdt, uavg=uavg,
        uu=uu, umu=umu, phi=phi,
    )
