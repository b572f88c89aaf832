# Frozen copy of sbdart_tpu_torch/config.py for the benchmark's reference: imports
# point into rtbench.reference.
# Later changes do not edit it.
"""Run configuration — the public API surface.

Mirrors SBDART's &INPUT namelist (sbdart.f, documented in rt.doc; SURVEY.md
appendix A1 catalogs the ~75 parameters and their defaults).  Existing
SBDART `INPUT` files load verbatim via :mod:`rtbench.reference.namelist`.

Defaults follow the reference's documented defaults (idatm=4 subarctic
summer, nstr=4, iout=10, vis=23 km, wlinf=wlsup=0.55 um, ...).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List


def _f5(v: float) -> List[float]:
    return dataclasses.field(default_factory=lambda: [v] * 5)


@dataclass
class Config:
    # ----- spectral range / resolution (sbdart.f namelist &INPUT) ---------
    wlinf: float = 0.55     # lower wavelength limit [um]
    wlsup: float = 0.55     # upper wavelength limit [um]
    wlinc: float = 0.0      # increment; 0 => default stepping. PINNED story
                            # (solar.py:spectral_grid implements exactly
                            # this): > 0 -> step in um; <= -1 -> |wlinc|
                            # step in wavenumber [cm^-1]; in (-1, 0) ->
                            # constant resolving power R = 1/|wlinc|
                            # (dlam = |wlinc| * lam)
    isat: int = 0           # satellite filter: 0 none, -1 filter.dat, >0 builtin
    nf: int = 2             # solar spectrum db: 0 flat, 1 5S, 2 LOWTRAN7, 3 MODTRAN3, -1 solar.dat

    # ----- atmosphere ------------------------------------------------------
    idatm: int = 4          # 1 tropical .. 6 US62, 0 => atms.dat user profile
    amix: float = -1.0      # blend factor user/model profile
    ngrid: int = 0          # regrid level count (0: native grid)
    zgrid1: float = 1.0     # regrid lower spacing [km]
    zgrid2: float = 30.0    # regrid upper spacing [km]
    pbar: float = -1.0      # surface pressure [mb]; <0 default; 0 => no Rayleigh
    zpres: float = -1.0     # surface altitude [km] (alternative to pbar)
    sclh2o: float = -1.0    # water vapor scale height [km]
    uw: float = -1.0        # precipitable water [g/cm^2]; <0 => profile default
    uo3: float = -1.0       # ozone column [atm-cm]; <0 => profile default
    o3trp: float = -1.0     # tropospheric ozone column [atm-cm]
    ztrp: float = 0.0       # tropopause altitude for o3trp [km]
    xrsc: float = 1.0       # Rayleigh scattering scale factor
    # uniformly-mixed gas scale factors (-1 => default amounts)
    xn2: float = -1.0
    xo2: float = -1.0
    xco2: float = -1.0
    xch4: float = -1.0
    xn2o: float = -1.0
    xco: float = -1.0
    xno2: float = -1.0
    xso2: float = -1.0
    xnh3: float = -1.0
    xno: float = -1.0
    xhno3: float = -1.0
    xo4: float = -1.0

    # ----- solar geometry --------------------------------------------------
    sza: float = 0.0        # solar zenith angle [deg]
    csza: float = -1.0      # cos(sza); >=0 overrides sza
    solfac: float = 1.0     # solar distance factor
    iday: int = 0           # day of year (0: use sza directly)
    time: float = 16.0      # UTC hours
    alat: float = -64.767   # latitude [deg]
    alon: float = -64.067   # longitude [deg]

    # ----- clouds (up to 5 slots; sbdart.f zcloud/tcloud/lwp/nre) ----------
    zcloud: List[float] = _f5(0.0)   # cloud layer altitudes [km]
    tcloud: List[float] = _f5(0.0)   # cloud optical depths at 0.55um
    lwp: List[float] = _f5(0.0)      # liquid water paths [g/m^2]
    nre: List[float] = _f5(8.0)      # effective radii [um]; <0 => ice
    rhcld: float = -1.0              # RH inside cloud
    krhclr: int = 0                  # clear-layer RH adjust flag
    jaer: List[int] = dataclasses.field(default_factory=lambda: [0] * 5)
    zaer: List[float] = _f5(0.0)     # stratospheric aerosol layer altitudes
    taerst: List[float] = _f5(0.0)   # stratospheric aerosol optical depths

    # ----- boundary-layer aerosol ------------------------------------------
    iaer: int = 0           # 0 none, 1 rural, 2 urban, 3 oceanic, 4 tropo, 5/-1 user
    vis: float = 23.0       # surface visibility [km]
    rhaer: float = -1.0     # relative humidity for aerosol model
    tbaer: float = -1.0     # BL aerosol optical depth at 0.55 um (overrides vis)
    wlbaer: List[float] = dataclasses.field(default_factory=lambda: [0.0] * 47)
    qbaer: List[float] = dataclasses.field(default_factory=lambda: [0.0] * 47)
    abaer: float = -1.0     # Angstrom exponent for user aerosol
    wbaer: List[float] = _f5(0.95)   # user aerosol ssa
    gbaer: List[float] = _f5(0.70)   # user aerosol asymmetry
    pmaer: List[float] = dataclasses.field(default_factory=list)  # user moments
    zbaer: List[float] = dataclasses.field(default_factory=lambda: [-1.0] * 50)
    dbaer: List[float] = dataclasses.field(default_factory=lambda: [-1.0] * 50)
    imoma: int = 3          # aerosol phase model (3 = Henyey-Greenstein)

    # ----- surface ---------------------------------------------------------
    isalb: int = 0          # 0 const albcon; 1 snow 2 clear water 3 lake 4 sea
                            # 5 sand 6 vegetation; 7+ mixtures via sc; -1 albedo.dat
    albcon: float = 0.0     # constant albedo
    sc: List[float] = dataclasses.field(default_factory=lambda: [1.0, 0.0, 0.0, 0.0])

    # ----- solver / output -------------------------------------------------
    nstr: int = 4           # number of streams (even)
    nzen: int = 0           # number of user zenith angles
    uzen: List[float] = dataclasses.field(default_factory=lambda: [-1.0] * 20)
    nphi: int = 0
    phi: List[float] = dataclasses.field(default_factory=lambda: [-1.0] * 20)
    phi0: float = 0.0       # solar azimuth [deg]
    zout: List[float] = dataclasses.field(default_factory=lambda: [0.0, 100.0])
    iout: int = 10          # output format selector (see outputs.py)
    deltam: bool = True     # delta-M scaling
    lamber: bool = True     # Lambertian surface
    ibcnd: int = 0          # 1 => albedo/transmission special mode (ALBTRN)
    fisot: float = 0.0      # isotropic top-boundary intensity [W/m^2]
    nothrm: int = -1        # -1 auto (thermal on for wl > 2 um), 0 on, 1 off
    kdist: int = 3          # gas k-distribution terms (3) ; 0 => gray per band
    btemp: float = -1.0     # bottom temperature [K]; <0 => lowest-level T
    ttemp: float = -1.0     # top temperature; <0 => highest-level T
    temis: float = 0.0      # top emissivity
    imomc: int = 3          # cloud phase model: 1 isotropic, 2 Rayleigh,
                            # 3 Henyey-Greenstein (reference default),
                            # 4 true Mie moments (re 2-32um, wl 0.4-4um)
    corint: bool = True     # Nakajima-Tanaka TMS intensity correction
    spowder: bool = False   # snow powder layer (sub-surface scattering slab)
    prnt: List[bool] = dataclasses.field(default_factory=lambda: [False] * 7)
    idb: List[int] = dataclasses.field(default_factory=lambda: [0] * 20)
    accur: float = 0.0      # (accepted for namelist parity; solver computes all
                            # azimuth modes branchlessly, so accur is unused)

    # ----- framework extensions (not in the reference namelist) -----------
    dtype: str = ""         # '', 'float32', 'float64'
    nlev_pad: int = 0       # pad vertical grid to this many levels (batching)

    # -- helpers -----------------------------------------------------------
    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def validate(self) -> "Config":
        if self.nstr < 2 or self.nstr % 2:
            raise ValueError(f"nstr must be even >= 2, got {self.nstr}")
        if self.wlsup < self.wlinf:
            raise ValueError("wlsup < wlinf")
        if not (0 <= self.albcon <= 1):
            raise ValueError("albcon outside [0, 1]")
        if self.idatm not in range(0, 7):
            raise ValueError(f"idatm must be 0..6, got {self.idatm}")
        return self


# Fields whose namelist value may be scalar-or-array
_ARRAY_FIELDS = {
    f.name for f in dataclasses.fields(Config)
    if f.default_factory is not dataclasses.MISSING  # type: ignore[misc]
}
