# Frozen copy of sbdart_tpu_torch/atmosphere.py for the benchmark's reference: imports
# point into rtbench.reference.
# Later changes do not edit it.
"""Atmospheric profile assembly.

Replaces the profile logic of sbdart.f + atms.f: select/blend model
atmospheres, apply user regrids and absorber rescalings, and derive the
per-layer absorber amounts the optical-property producers consume.

All of this is *setup* (host-side numpy): it runs once per configuration,
produces a `Profile`, and the pipeline turns profiles into batched jnp
tensors.  Column *perturbations* for large batches (config 5 of
BASELINE.json) are applied later as tensor scalings, keeping this layer out
of the hot path.

Level ordering: TOA first (z descending), matching the solver's layer 0 =
top convention.

Reference parity map:
  ATMS (atms.f)           -> model_atmosphere + amix blending + atms.dat
  ZGRID (sbdart.f)        -> regrid()
  absorber scaling (uw,
  uo3, sclh2o, pbar, ...) -> apply_scalings()
  SATURE                  -> saturation_vapor_pressure()
"""

from __future__ import annotations

import dataclasses

import numpy as np

from rtbench.reference.config import Config
from rtbench.reference.constants import AVOGADRO, AIR_MOLAR_MASS
from rtbench.reference.data.atmospheres import (
    MIXING_RATIOS,
    O3_DENSITY_STP,
    model_atmosphere,
)


@dataclasses.dataclass
class Profile:
    """Atmospheric column on levels (TOA-first)."""
    z: np.ndarray    # [nlev] km
    p: np.ndarray    # [nlev] mb
    t: np.ndarray    # [nlev] K
    wh: np.ndarray   # [nlev] water vapor density g/m^3
    wo: np.ndarray   # [nlev] ozone density g/m^3

    @property
    def nlev(self) -> int:
        return len(self.z)

    @property
    def nlyr(self) -> int:
        return len(self.z) - 1

    # ---- derived per-layer quantities ------------------------------------
    def layer_h2o(self) -> np.ndarray:
        """Water vapor path per layer [g/cm^2]."""
        dz = -np.diff(self.z)  # km, positive (TOA-first)
        return 0.5 * (self.wh[:-1] + self.wh[1:]) * dz * 0.1

    def layer_o3(self) -> np.ndarray:
        """Ozone path per layer [atm-cm]."""
        dz = -np.diff(self.z)
        g_cm2 = 0.5 * (self.wo[:-1] + self.wo[1:]) * dz * 0.1
        return g_cm2 / O3_DENSITY_STP

    def layer_air(self) -> np.ndarray:
        """Air column per layer [molecules/cm^2]."""
        dp = np.diff(self.p)  # mb, positive downward
        return dp * 1.019 / AIR_MOLAR_MASS * AVOGADRO  # g/cm^2 -> molec/cm^2

    def layer_gas(self, vmr: float) -> np.ndarray:
        """Column of a uniformly mixed gas per layer [molecules/cm^2]."""
        return self.layer_air() * vmr

    def layer_pressure(self) -> np.ndarray:
        """Layer effective pressure [mb] (geometric mean)."""
        return np.sqrt(self.p[:-1] * self.p[1:])

    def layer_temperature(self) -> np.ndarray:
        return 0.5 * (self.t[:-1] + self.t[1:])

    def column_h2o(self) -> float:
        return float(self.layer_h2o().sum())

    def column_o3(self) -> float:
        return float(self.layer_o3().sum())


def saturation_vapor_pressure(t: np.ndarray) -> np.ndarray:
    """Saturation vapor pressure over water [mb] (Magnus; SATURE equiv)."""
    tc = np.asarray(t) - 273.15
    return 6.112 * np.exp(17.67 * tc / (tc + 243.5))


def saturation_density(t: np.ndarray) -> np.ndarray:
    """Saturation water-vapor density [g/m^3]."""
    es = saturation_vapor_pressure(t)  # mb
    # rho = es / (Rv T); Rv = 461.5 J/(kg K); mb -> Pa: x100; kg->g: x1000
    return es * 100.0 / (461.5 * np.asarray(t)) * 1000.0


def relative_humidity(profile: Profile) -> np.ndarray:
    """RH [%] at levels."""
    return 100.0 * profile.wh / np.maximum(saturation_density(profile.t), 1e-30)


def user_profile_from_array(data: np.ndarray) -> Profile:
    """Build from an atms.dat-style table: rows of (z, p, t, wh, wo).

    Accepts either TOA-first or surface-first input (sorted internally).
    """
    data = np.asarray(data, np.float64)
    if data.ndim != 2 or data.shape[1] < 5:
        raise ValueError("atms.dat table needs columns z, p, t, wh, wo")
    order = np.argsort(data[:, 0])[::-1]
    d = data[order]
    return Profile(d[:, 0], d[:, 1], d[:, 2], d[:, 3], d[:, 4])


def load_atms_dat(path: str) -> Profile:
    """Read SBDART's `atms.dat` format: first line nn, then nn rows."""
    with open(path) as fh:
        tokens = fh.read().split()
    nn = int(float(tokens[0]))
    vals = np.array([float(x) for x in tokens[1: 1 + 5 * nn]]).reshape(nn, 5)
    return user_profile_from_array(vals)


def regrid(profile: Profile, ngrid: int, zgrid1: float, zgrid2: float) -> Profile:
    """Re-interpolate to a grid with spacing growing from zgrid1 (surface)
    to zgrid2 (top) — sbdart.f ZGRID equivalent.

    ngrid > 0: target about `ngrid` levels;  ngrid < 0: exactly |ngrid|.
    """
    if ngrid == 0:
        return profile
    ztop, zbot = profile.z[0], profile.z[-1]
    n = abs(int(ngrid))
    # geometric spacing progression from zgrid1 to zgrid2 over n-1 layers
    r = (zgrid2 / max(zgrid1, 1e-3)) ** (1.0 / max(n - 2, 1))
    steps = zgrid1 * r ** np.arange(n - 1)
    z = zbot + np.concatenate([[0.0], np.cumsum(steps)])
    z = z[z < ztop]
    z = np.concatenate([z, [ztop]])
    z = z[::-1]  # TOA-first
    return _interp_profile(profile, z)


def _interp_profile(profile: Profile, z_new: np.ndarray) -> Profile:
    """Interpolate (log-p linear in z, others linear) onto z_new (TOA-first)."""
    zs = profile.z[::-1]
    lin = lambda v: np.interp(z_new[::-1], zs, v[::-1])[::-1]
    logp = np.interp(z_new[::-1], zs, np.log(profile.p[::-1]))[::-1]
    return Profile(
        z_new.copy(), np.exp(logp), lin(profile.t),
        lin(profile.wh), lin(profile.wo),
    )


def apply_scalings(profile: Profile, cfg: Config) -> Profile:
    """Absorber/pressure rescalings from the namelist (uw, uo3, sclh2o,
    pbar/zpres, o3trp/ztrp)."""
    p = profile
    z, pr, t, wh, wo = (a.copy() for a in (p.z, p.p, p.t, p.wh, p.wo))

    if cfg.zpres >= 0.0:
        # truncate the column at altitude zpres (surface raised)
        keep = z >= cfg.zpres
        if keep.sum() < 2:
            raise ValueError("zpres leaves < 2 levels")
        z, pr, t, wh, wo = z[keep], pr[keep], t[keep], wh[keep], wo[keep]

    if cfg.pbar == 0.0:
        pass  # Rayleigh disabled downstream (pbar==0 convention)
    elif cfg.pbar > 0.0:
        pr = pr * (cfg.pbar / pr[-1])

    if cfg.sclh2o > 0.0:
        # replace the vapor profile by an exponential with scale height
        # sclh2o, preserving the column amount
        col = Profile(z, pr, t, wh, wo).column_h2o()
        shape = np.exp(-np.maximum(z - z[-1], 0.0) / cfg.sclh2o)
        new_col = Profile(z, pr, t, shape, wo).column_h2o()
        wh = shape * (col / max(new_col, 1e-30))

    prof2 = Profile(z, pr, t, wh, wo)
    if cfg.uw >= 0.0:
        cur = prof2.column_h2o()
        wh = wh * (cfg.uw / max(cur, 1e-30))
        prof2 = Profile(z, pr, t, wh, wo)

    if cfg.uo3 >= 0.0 or cfg.o3trp >= 0.0:
        strat = z >= cfg.ztrp if cfg.ztrp > 0 else np.ones_like(z, bool)
        if cfg.uo3 >= 0.0:
            mask = strat
            cur = Profile(z, pr, t, wh, np.where(mask, wo, 0.0)).column_o3()
            wo = np.where(mask, wo * (cfg.uo3 / max(cur, 1e-30)), wo)
        if cfg.o3trp >= 0.0 and cfg.ztrp > 0:
            mask = ~strat
            cur = Profile(z, pr, t, wh, np.where(mask, wo, 0.0)).column_o3()
            wo = np.where(mask, wo * (cfg.o3trp / max(cur, 1e-30)), wo)
        prof2 = Profile(z, pr, t, wh, wo)

    return prof2


def insert_levels(profile: Profile, z_extra) -> Profile:
    """Insert altitudes into the level grid (interpolating the profile).

    The reference folds the zout output altitudes into its zgrid so DISORT
    reports fluxes exactly there (sbdart.f ZGRID + disort.f USRTAU);
    inserting them as levels reproduces that without a separate utau path.
    """
    z = profile.z
    extra = [
        float(ze) for ze in np.atleast_1d(z_extra)
        if z[-1] < ze < z[0] and np.abs(z - ze).min() > 1e-6
    ]
    if not extra:
        return profile
    z_new = np.sort(np.unique(np.concatenate([z, extra])))[::-1]
    return _interp_profile(profile, z_new)


def build_profile(cfg: Config, user: Profile | None = None) -> Profile:
    """Full profile assembly: select model / user profile, blend (amix),
    regrid, rescale, and insert the zout output altitudes as grid levels."""
    if cfg.idatm == 0:
        if user is None:
            user = load_atms_dat("atms.dat")
        prof = user
        if 0.0 < cfg.amix <= 1.0:
            raise ValueError("amix blending requires idatm>0 model to blend")
    else:
        m = model_atmosphere(cfg.idatm)
        prof = Profile(m["z"], m["p"], m["t"], m["wh"], m["wo"])
        if user is not None and 0.0 < cfg.amix <= 1.0:
            u_on_m = _interp_profile(user, prof.z)
            a = cfg.amix
            prof = Profile(
                prof.z,
                a * u_on_m.p + (1 - a) * prof.p,
                a * u_on_m.t + (1 - a) * prof.t,
                a * u_on_m.wh + (1 - a) * prof.wh,
                a * u_on_m.wo + (1 - a) * prof.wo,
            )
    prof = regrid(prof, cfg.ngrid, cfg.zgrid1, cfg.zgrid2)
    prof = insert_levels(prof, cfg.zout)
    prof = apply_scalings(prof, cfg)
    return prof
