# Frozen copy of sbdart_tpu_torch/gas.py for the benchmark's reference: imports
# point into rtbench.reference.
# Later changes do not edit it.
"""Gas absorption: Malkmus band model -> 3-term k-distribution.

Replaces taugas.f (reference component #3).  The reference evaluates
LOWTRAN7 band transmissions at 20 cm^-1 resolution and fits a 3-term
exponential sum T(u) = sum_i w_i exp(-k_i u) per band (the `kdist` loop of
sbdart.f).  Here the same architecture is built the correlated-k way:

  1. each gas has Malkmus parameters (S, beta) per wavelength
     (data/gas_bands20.py for the six major gases, data/gas_bands.py for
     the trace gases);
  2. the Malkmus k-distribution is ANALYTIC — an inverse-Gaussian density
     f(k) = (1/2) sqrt(beta S / pi) k^-3/2 exp(beta/2) exp(-(beta/4)(k/S + S/k))
     (Lacis & Oinas 1991) — so the 3 k-terms are Gauss–Legendre quantiles of
     its cumulative in g-space: exact, no nonlinear fitting;
  3. per band the *dominant* gas gets the 3-term treatment; minor gases are
     added as gray (band-effective) absorption, and the electronic-band
     absorbers (O3 UV/vis, NO2) plus the H2O window continuum are gray
     Beer–Lambert cross-sections;
  4. pressure handling is TWO-PARAMETER Curtis–Godson (round 5).  For the
     major gases the Lorentz overlap parameter carries the pressure
     explicitly — beta_l = beta0(nu) * (p_l + p_d)/p0 * (T0/T_l)^0.5 per
     layer (gamma_L ~ p T^-1/2) — and amounts carry only the
     line-strength temperature factor u_l (T0/T_l)^b.  The dominant-gas
     k-quantiles are evaluated PER LAYER at beta_l (correlated-k across
     layers), and gray/minor columns use the Curtis–Godson effective pair
     (u_cg, beta_cg) = (sum u_l, beta0 * sum(u_l pfac_l)/sum u_l).  This
     makes the WEAK limit exact (A = S u, no spurious pressure factor —
     the round-4 one-parameter scaling u (p/p0)^a corrupted it) and
     reproduces the strong-line sqrt(S beta(pbar) u) law with the
     pressure dependence stated instead of absorbed into a fitted
     calibration (see data/gas_bands20.py:BETA_CAL provenance).  Trace
     gases (co, so2, nh3, no, hno3) and the O4 collision pair keep the
     legacy one-parameter scaling u (p/p0)^a (T0/T)^b — their bands are
     minor and O4's p^2 density dependence lives in the amount exponent.

     KNOWN QUADRATURE LIMITATION: the weak-limit exactness above holds
     for the ANALYTIC Malkmus forms (the gray/minor path).  The 3-point
     Gauss quantile quadrature under-resolves the extreme skew of
     small-beta k-distributions (measured: sum w_i k_i / S = 0.88 at
     beta = 1 but 0.07 at beta = 0.01), so optically-thin absorption in
     the 3-term dominant-gas path is underestimated where beta_l is
     small.  This is intrinsic to ANY 3-term representation (the
     reference's 3-term exponential-sum fit trades the same dof) and is
     absorbed by the integral anchors; revisit with more k-terms if
     thin-band heating aloft ever becomes a product requirement.

Everything here is host-side numpy setup producing the per-band tensors
tau_gas[nwl, nk, nlyr] and weights wk[nwl, nk] the pipeline consumes.
"""

from __future__ import annotations

import functools

import numpy as np

from rtbench.reference.atmosphere import Profile
from rtbench.reference.config import Config
from rtbench.reference.data.atmospheres import MIXING_RATIOS
from rtbench.reference.data.gas_bands import (
    DOPPLER_FLOOR_MB,
    SCALING,
    band_parameters,
    h2o_continuum_coeff,
    no2_xsec,
    o3_continuum_xsec,
)

# 3-point Gauss–Legendre nodes/weights on (0, 1) — the k-distribution
# quadrature (kdist=3, the reference default).
_GL3_G = np.array([0.1127016653792583, 0.5, 0.8872983346207417])
_GL3_W = np.array([5.0 / 18.0, 8.0 / 18.0, 5.0 / 18.0])

P0_MB = 1013.25
T0_K = 273.15
_LOSCHMIDT_CM2 = 2.6867811e19  # molecules/cm^2 per atm-cm

# mapping from config scale-factor fields to gas names
GAS_SCALE_FIELDS = {
    "h2o": None, "o3": None,  # profile-driven
    "co2": "xco2", "ch4": "xch4", "n2o": "xn2o", "co": "xco",
    "o2": "xo2", "no2": "xno2", "so2": "xso2", "nh3": "xnh3",
    "no": "xno", "hno3": "xhno3", "o4": "xo4", "n2": "xn2",
}


def malkmus_transmission(s, beta, u):
    """Malkmus band transmission T(u) = exp(-(beta/2)(sqrt(1+4Su/beta)-1))."""
    s, beta, u = np.broadcast_arrays(s, beta, u)
    arg = 1.0 + 4.0 * s * u / np.maximum(beta, 1e-30)
    return np.exp(-0.5 * beta * (np.sqrt(arg) - 1.0))


def malkmus_k_quantiles(s: np.ndarray, beta: np.ndarray) -> np.ndarray:
    """k at the 3 Gauss quantiles of the Malkmus k-distribution.

    s, beta: [nb] band parameters.  Returns k [nb, 3] (per absorber unit).

    The cumulative G(k) is computed on a log-k grid from the analytic
    inverse-Gaussian density and inverted by interpolation.
    """
    s = np.maximum(np.asarray(s, np.float64), 1e-300)
    beta = np.maximum(np.asarray(beta, np.float64), 1e-6)
    nb = s.shape[0]
    # log-k grid around S: k = S * exp(x); f(k) dk expressed in x:
    #   f(k) k dx with k = S e^x  ->  (1/2) sqrt(beta/pi) e^{beta/2}
    #   e^{-x/2} exp(-(beta/2) cosh x) dx
    x = np.linspace(-40.0, 25.0, 600)
    bx = beta[:, None]
    # guard cosh overflow: where (beta/2)cosh x > 700, density is 0 anyway
    chx = np.cosh(np.clip(x, -700, 700))[None, :]
    expo = -0.5 * x[None, :] + bx / 2.0 * (1.0 - chx)
    dens = 0.5 * np.sqrt(bx / np.pi) * np.exp(np.clip(expo, -745.0, 50.0))
    cum = np.concatenate(
        [np.zeros((nb, 1)), np.cumsum(
            0.5 * (dens[:, 1:] + dens[:, :-1]) * np.diff(x), axis=1
        )], axis=1,
    )
    total = np.maximum(cum[:, -1:], 1e-300)
    gnorm = cum / total
    out = np.empty((nb, 3))
    for i in range(nb):
        out[i] = np.interp(_GL3_G, gnorm[i], x)
    return s[:, None] * np.exp(out)


# The Malkmus density in x = ln(k/S) depends on beta ALONE, so the quantile
# RATIOS q_i(beta) = k_i/S are a one-parameter family: tabulate once on a
# log-beta grid and per-(band, layer) quantiles become an interpolation.
@functools.lru_cache(maxsize=1)
def _quantile_ratio_table():
    lb = np.linspace(np.log(1e-7), np.log(1e4), 221)
    q = malkmus_k_quantiles(np.ones_like(lb), np.exp(lb))      # [nb, 3]
    return lb, np.log(q)


def malkmus_k_quantiles_beta(s: np.ndarray, beta: np.ndarray) -> np.ndarray:
    """k quantiles for arbitrary-shaped (s, beta) via the ratio table.

    Matches malkmus_k_quantiles to the log-beta interpolation tolerance
    (tests/test_physics_setup.py pins the agreement); used for the
    per-layer Curtis–Godson beta_l path where the direct cumulative
    inversion would run per (band x layer).
    """
    lb, lq = _quantile_ratio_table()
    lbv = np.log(np.clip(np.asarray(beta, np.float64), 1e-7, 1e4))
    out = np.empty(np.shape(lbv) + (3,))
    for i in range(3):
        out[..., i] = np.exp(np.interp(lbv, lb, lq[:, i]))
    return np.asarray(s, np.float64)[..., None] * out


# major gases: two-parameter Curtis-Godson (beta carries pressure);
# trace gases + O4: legacy one-parameter amount scaling
CG_GASES = ("h2o", "co2", "o3", "o2", "ch4", "n2o")


class GasAmounts:
    """Per-layer scaled absorber amounts for every gas.

    For the CG_GASES, `scaled` carries ONLY the line-strength temperature
    factor u (T0/T)^b and `pfac` carries the per-layer Lorentz-broadening
    factor (p + p_d)/p0 * (T0/T)^0.5 that multiplies beta0 (the
    two-parameter Curtis–Godson split).  For the legacy trace gases,
    `scaled` is the round-4 one-parameter u (p/p0)^a (T0/T)^b and `pfac`
    is 1 (beta stays at its table value).
    """

    def __init__(self, profile: Profile, cfg: Config):
        self.profile = profile
        play = profile.layer_pressure()
        tlay = profile.layer_temperature()
        self.amounts: dict[str, np.ndarray] = {}
        self.scaled: dict[str, np.ndarray] = {}
        self.pfac: dict[str, np.ndarray] = {}

        def scalef(field: str | None) -> float:
            if field is None:
                return 1.0
            v = float(getattr(cfg, field))
            return 1.0 if v < 0 else v

        for gas in SCALING:
            if gas == "h2o":
                u = profile.layer_h2o()                      # g/cm^2
            elif gas == "o3":
                u = profile.layer_o3()                       # atm-cm
            elif gas == "o4":
                # collision pair: proportional to (O2 partial density)^2
                vmr = MIXING_RATIOS["o2"] * scalef("xo2")
                u = (profile.layer_gas(vmr) * 1e-20) ** 2 * 1e-3
                u = u * scalef("xo4")
            else:
                vmr = MIXING_RATIOS.get(gas, 0.0) * scalef(GAS_SCALE_FIELDS[gas])
                u = profile.layer_gas(vmr) * 1e-20           # 1e20 molec/cm^2
            self.amounts[gas] = u
            a, b = SCALING[gas]
            # Doppler-floor equivalent pressure keeps stratospheric line
            # cores absorbing (see data/gas_bands.py:DOPPLER_FLOOR_MB)
            pd = DOPPLER_FLOOR_MB.get(gas, 0.0)
            if gas in CG_GASES:
                self.scaled[gas] = u * (T0_K / tlay) ** b
                self.pfac[gas] = (
                    ((play + pd) / P0_MB) * (T0_K / tlay) ** 0.5
                )
            else:
                self.scaled[gas] = (
                    u * ((play + pd) / P0_MB) ** a * (T0_K / tlay) ** b
                )
                self.pfac[gas] = np.ones_like(play)

        # vapor pressure weighting for the e-type continuum
        wh_lay = 0.5 * (profile.wh[:-1] + profile.wh[1:])    # g/m^3
        self.h2o_cont = profile.layer_h2o() * (wh_lay / 10.0) * (296.0 / tlay) ** 4
        self.no2_col = profile.layer_gas(
            MIXING_RATIOS["no2"] * scalef("xno2")
        )                                                    # molecules/cm^2
        self.o3_molec = profile.layer_o3() * _LOSCHMIDT_CM2  # molecules/cm^2

    def cg_column(self, gas: str) -> tuple[float, float]:
        """Curtis–Godson column pair: (u_cg, beta-factor).

        u_cg = sum of (T-scaled) amounts; the beta factor is the
        amount-weighted mean of pfac — multiply a band's beta0 by it for
        the column-equivalent homogeneous Malkmus parameters.
        """
        u = self.scaled[gas]
        ucol = max(float(u.sum()), 1e-300)
        bfac = float((u * self.pfac[gas]).sum() / ucol)
        return ucol, bfac


def gas_optical_depth(
    profile: Profile, cfg: Config, wl_um: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """tau_gas[nwl, nk, nlyr] and k-weights wk[nwl, nk].

    kdist=0 requests gray (band-effective single-k) treatment; the default
    kdist=3 gives the 3-term distribution of the dominant gas.
    """
    wl = np.atleast_1d(np.asarray(wl_um, np.float64))
    nk = 3 if cfg.kdist != 0 else 1
    amounts = GasAmounts(profile, cfg)
    nlyr = profile.nlyr
    nwl = wl.shape[0]

    tau = np.zeros((nwl, nk, nlyr))
    wk = np.tile(_GL3_W if nk == 3 else np.array([1.0]), (nwl, 1))

    # --- line absorbers: Malkmus bands ------------------------------------
    # Major gases use the 20 cm^-1 tables (published band intensities +
    # spectroscopic envelopes — data/gas_bands20.py); minor gases keep the
    # band-scale envelopes of data/gas_bands.py.
    from rtbench.reference.data.gas_bands20 import FEATURES20, band_parameters20

    line_gases = [g for g in SCALING if g != "n2"]
    svals = {}
    for gas in line_gases:
        if gas in FEATURES20:
            s, beta = band_parameters20(gas, wl)
        else:
            s, beta = band_parameters(gas, wl)
        svals[gas] = (s, beta)

    ucols = {g: max(amounts.scaled[g].sum(), 1e-300) for g in line_gases}
    # dominant gas per band by column band optical depth S * u
    su = np.stack([svals[g][0] * ucols[g] for g in line_gases])  # [ng, nwl]
    dom = np.argmax(su, axis=0)                                  # [nwl]
    any_line = su.max(axis=0) > 1e-10

    for gi, gas in enumerate(line_gases):
        s, beta = svals[gas]
        u_lay = amounts.scaled[gas]                              # [nlyr]
        ucol = ucols[gas]
        is_dom = (dom == gi) & any_line & (s > 0)
        # Curtis–Godson column beta for the gray/minor treatment (pfac = 1
        # for the legacy trace gases, so this is their table beta)
        _, bfac = amounts.cg_column(gas)
        beta_col = beta * bfac
        # gray effective k for this gas (used when minor, or kdist=0)
        t_band = malkmus_transmission(s, beta_col, ucol)
        kbar = -np.log(np.maximum(t_band, 1e-300)) / ucol        # [nwl]
        if nk == 3:
            idx = np.where(is_dom)[0]
            if idx.size:
                if gas in CG_GASES:
                    # per-layer beta_l = beta0 (p_l+p_d)/p0 (T0/T)^0.5:
                    # k-quantiles evaluated per layer (correlated-k across
                    # layers), amounts carry only the T factor
                    pf = amounts.pfac[gas]                       # [nlyr]
                    beta_l = beta[idx, None] * pf[None, :]       # [nb, nlyr]
                    kq = malkmus_k_quantiles_beta(
                        np.broadcast_to(s[idx, None], beta_l.shape), beta_l
                    )                                            # [nb, L, 3]
                    tau[idx] += np.moveaxis(kq, 2, 1) \
                        * u_lay[None, None, :]
                else:
                    kq = malkmus_k_quantiles(s[idx], beta[idx])  # [nb, 3]
                    tau[idx] += kq[:, :, None] * u_lay[None, None, :]
            minor = ~is_dom
            tau[minor] += (kbar[minor, None, None] * u_lay[None, None, :])
        else:
            tau[:, 0, :] += kbar[:, None] * u_lay[None, :]

    # --- gray continua ----------------------------------------------------
    cont = np.zeros((nwl, nlyr))
    cont += o3_continuum_xsec(wl)[:, None] * amounts.o3_molec[None, :]
    cont += no2_xsec(wl)[:, None] * amounts.no2_col[None, :]
    cont += h2o_continuum_coeff(wl)[:, None] * amounts.h2o_cont[None, :]
    tau += cont[:, None, :]

    return tau, wk
