# Frozen copy of sbdart_tpu_torch/clouds.py for the benchmark's reference: imports
# point into rtbench.reference.
# Later changes do not edit it.
"""Cloud optical properties.

Replaces taucloud.f (reference component #4): places up to 5 cloud slots
(zcloud/tcloud/lwp/nre namelist arrays) or per-layer user clouds
(usrcld.dat) into the column and produces per-(wavelength, layer) optical
depth, single-scatter albedo and asymmetry from the Mie tables
(data/mie.py).  Phase function is Henyey–Greenstein from g (imomc=3, the
reference default).

Placement semantics (rt.doc):
  * zcloud[j] > 0: cloud occupies the layer(s) spanning that altitude;
  * zcloud[j] < 0: slot j extends the previous slot's cloud from
    zcloud[j-1] down/up to |zcloud[j]| (a multi-layer cloud);
  * tcloud[j] > 0: optical depth at 0.55 um (LWP derived);
    otherwise lwp[j] > 0 gives the liquid water path directly;
  * nre[j] > 0: liquid water effective radius [um]; nre[j] < 0: ice cloud
    with |nre| effective radius.
"""

from __future__ import annotations

import numpy as np

from rtbench.reference.atmosphere import Profile, saturation_density
from rtbench.reference.config import Config
from rtbench.reference.data.mie import cloud_properties


def _slot_spans(cfg: Config):
    """Resolve cloud slots into (z_lo, z_hi, lwp, re, phase) tuples."""
    spans = []
    j = 0
    zc = list(cfg.zcloud)
    while j < 5:
        z = zc[j]
        has_amount = cfg.tcloud[j] != 0.0 or cfg.lwp[j] > 0.0
        if z > 0.0 and has_amount:
            z_hi = z
            j2 = j + 1
            if j2 < 5 and zc[j2] < 0.0:
                z_hi = abs(zc[j2])
            z_lo = z
            re = cfg.nre[j]
            phase = "water" if re >= 0 else "ice"
            spans.append(
                (min(z_lo, z_hi), max(z_lo, z_hi), cfg.lwp[j],
                 cfg.tcloud[j], abs(re) if re != 0 else 8.0, phase)
            )
        j += 1
    return spans


def _layer_weights(profile: Profile, z_lo: float, z_hi: float) -> np.ndarray:
    """Fraction of a cloud span falling in each layer (TOA-first layers)."""
    z_top = profile.z[:-1]
    z_bot = profile.z[1:]
    if z_hi <= z_lo:
        # single-altitude cloud: put it in the layer containing z_lo
        w = ((z_bot <= z_lo) & (z_lo < z_top)).astype(float)
        if w.sum() == 0:
            w[-1] = 1.0  # below lowest level: in the surface layer
        return w
    ov = np.maximum(
        0.0, np.minimum(z_top, z_hi) - np.maximum(z_bot, z_lo)
    )
    tot = ov.sum()
    return ov / tot if tot > 0 else ov


def _cloud_elements(profile: Profile, cfg: Config,
                    usrcld: np.ndarray | None):
    """Yield (lwp_per_layer [nlyr], re, phase) for every cloud element."""
    nlyr = profile.nlyr
    if usrcld is not None:
        u = np.asarray(usrcld, np.float64)
        for li in range(min(len(u), nlyr)):
            lwp_i, re_i = u[li, 0], u[li, 1]
            if lwp_i <= 0:
                continue
            phase = "water"
            if u.shape[1] > 2 and u[li, 2] < 0:
                phase = "ice"
            onelyr = np.zeros(nlyr)
            onelyr[li] = lwp_i
            yield onelyr, abs(re_i), phase
    else:
        for z_lo, z_hi, lwp, tc, re, phase in _slot_spans(cfg):
            wlyr = _layer_weights(profile, z_lo, z_hi)
            if tc != 0.0:
                # optical depth given at 0.55 um -> equivalent LWP
                ke55, _, _ = cloud_properties(re, np.array([0.55]), phase)
                lwp_tot = abs(tc) / float(ke55[0])
            else:
                lwp_tot = lwp
            yield lwp_tot * wlyr, re, phase


def cloud_optical_properties(
    profile: Profile,
    cfg: Config,
    wl_um: np.ndarray,
    usrcld: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(tau, w0, g) each [nwl, nlyr] for the cloud component.

    usrcld: optional per-layer array [nlyr, 2 or 3] of (lwp, re[, phase>0
    water/ <0 ice]) — the usrcld.dat path (rows TOA-first like the grid).
    """
    wl = np.atleast_1d(np.asarray(wl_um, np.float64))
    nwl, nlyr = wl.shape[0], profile.nlyr
    tau = np.zeros((nwl, nlyr))
    scat = np.zeros((nwl, nlyr))
    gscat = np.zeros((nwl, nlyr))

    for lwp_layer, re, phase in _cloud_elements(profile, cfg, usrcld):
        if lwp_layer.sum() <= 0:
            continue
        ke, w0, g = cloud_properties(re, wl, phase)      # [nwl]
        t = ke[:, None] * lwp_layer[None, :]
        tau[...] += t
        scat[...] += t * w0[:, None]
        gscat[...] += t * w0[:, None] * g[:, None]

    w0 = np.where(tau > 0, scat / np.maximum(tau, 1e-300), 0.0)
    g = np.where(scat > 0, gscat / np.maximum(scat, 1e-300), 0.0)
    return tau, w0, g


def cloud_mie_moments(
    profile: Profile,
    cfg: Config,
    wl_um: np.ndarray,
    nmom: int,
    usrcld: np.ndarray | None = None,
) -> np.ndarray:
    """Scattering-weighted TRUE Mie phase-function moments [nwl, nlyr, nmom].

    The imomc=4 path (disort.f:GETMOM-class real moments instead of
    Henyey-Greenstein): per cloud element the precomputed gamma-averaged
    Mie moments (data/mie.py:cloud_moments) are combined with
    scattering-optical-depth weights, exactly like g in
    cloud_optical_properties.  Cloud-free (wl, layer) cells fall back to
    the isotropic vector (they carry zero scattering weight downstream).
    """
    from rtbench.reference.data.mie import cloud_moments

    wl = np.atleast_1d(np.asarray(wl_um, np.float64))
    nwl, nlyr = wl.shape[0], profile.nlyr
    scat = np.zeros((nwl, nlyr))
    mscat = np.zeros((nwl, nlyr, nmom))

    for lwp_layer, re, phase in _cloud_elements(profile, cfg, usrcld):
        if lwp_layer.sum() <= 0:
            continue
        ke, w0, _g = cloud_properties(re, wl, phase)
        mom = cloud_moments(re, wl, nmom, phase)         # [nwl, nmom]
        sc = ke[:, None] * lwp_layer[None, :] * w0[:, None]
        scat += sc
        mscat += sc[..., None] * mom[:, None, :]

    mom = np.where(
        scat[..., None] > 0, mscat / np.maximum(scat[..., None], 1e-300), 0.0
    )
    mom[..., 0] = 1.0
    return mom


def load_usrcld_dat(path: str, nlyr: int) -> np.ndarray:
    """Read usrcld.dat: one row per layer (TOA-first): lwp, re[, phase]."""
    d = np.atleast_2d(np.loadtxt(path))
    return d


def apply_cloud_humidity(profile: Profile, cfg: Config) -> Profile:
    """rhcld: set in-cloud relative humidity (affects gas absorption).

    krhclr selects what happens to CLEAR layers afterwards (sbdart.f
    namelist; semantics per the rt.doc description — provisional until the
    reference mount is populated, SURVEY.md section 0):

      krhclr=0 (default): clear-layer vapor densities are rescaled by a
        common factor so the COLUMN water vapor stays at its original value
        (the in-cloud humidification is compensated outside the cloud);
      krhclr=1: clear layers keep their original humidity; the column
        total changes by whatever the in-cloud adjustment added.
    """
    if cfg.krhclr not in (0, 1):
        raise ValueError(f"krhclr must be 0 or 1, got {cfg.krhclr}")
    if cfg.rhcld < 0:
        return profile
    spans = _slot_spans(cfg)
    if not spans:
        return profile
    wh = profile.wh.copy()
    in_cloud = np.zeros(profile.z.shape, bool)
    for z_lo, z_hi, *_ in spans:
        sel = (profile.z >= z_lo - 0.5) & (profile.z <= z_hi + 0.5)
        wh[sel] = cfg.rhcld / 100.0 * saturation_density(profile.t[sel])
        in_cloud |= sel
    if cfg.krhclr == 0 and (~in_cloud).any():
        # compensate clear layers to preserve the original column vapor;
        # column integrals via the same trapezoid rule as layer_h2o
        def col(whv):
            lay = 0.5 * (whv[:-1] + whv[1:])
            dz = -np.diff(profile.z)
            return float(np.sum(lay * dz))

        orig = col(profile.wh)
        cloud_only = np.where(in_cloud, wh, 0.0)
        clear_only = np.where(in_cloud, 0.0, profile.wh)
        clear_col = col(clear_only)
        if clear_col > 0:
            scale = max(orig - col(cloud_only), 0.0) / clear_col
            wh = np.where(in_cloud, wh, profile.wh * scale)
    return Profile(profile.z, profile.p, profile.t, wh, profile.wo)
