# Frozen copy of sbdart_tpu_torch/data/mie.py for the benchmark's reference: imports
# point into rtbench.reference.
# Later changes do not edit it.
"""Mie scattering: cloud-droplet optical property tables.

Replaces the precomputed Mie tables of taucloud.f (reference component #4).
REGENERATED from first principles (see data/__init__.py): Bohren & Huffman
Mie coefficients a_n, b_n (logarithmic-derivative downward recurrence) give
Q_ext, Q_sca, and the asymmetry parameter g via the Wiscombe series — no
angular grids needed — integrated over a gamma size distribution
(effective variance 0.11) on an effective-radius x wavelength grid.

The reference (and this framework, with the default imomc=3) represents the
cloud phase function as Henyey–Greenstein from g, so (k_ext per LWP, w0, g)
is the complete table.  Tables are generated once and cached to
`mie_tables.npz` next to this module (committed for determinism).
"""

from __future__ import annotations

import functools
import os

import numpy as np

from rtbench.reference.data.refractive import ice_index, water_index

RE_GRID = np.array(
    [2.0, 3.0, 4.0, 6.0, 8.0, 10.0, 12.0, 16.0, 20.0, 24.0, 32.0, 48.0,
     64.0, 96.0, 128.0]
)
WL_GRID = np.concatenate([
    np.geomspace(0.25, 4.0, 44), np.geomspace(4.3, 100.0, 24),
])
VEFF = 0.11          # gamma-distribution effective variance
_NPZ = os.path.join(os.path.dirname(__file__), "mie_tables.npz")


def mie_batch(x: np.ndarray, m: complex):
    """Batched Mie efficiencies: Q_ext, Q_sca, g for an array of size
    parameters `x` sharing one refractive index `m`.

    The three sequential recurrences (log-derivative D_n downward,
    Riccati–Bessel psi/chi upward) run to the largest x's term count with
    per-x masking of the partial sums; overflow in the masked beyond-cutoff
    region is harmless (masked before summation).
    """
    x = np.asarray(x, np.float64)
    nmax_each = (x + 4.05 * np.cbrt(x) + 2.0).astype(int)
    nmax = int(nmax_each.max())
    nmx = nmax + 16
    mx = m * x

    with np.errstate(all="ignore"):
        d = np.zeros_like(mx)          # D_nmx
        dstack = np.empty((nmax + 1,) + x.shape, complex)
        for n in range(nmx, 0, -1):
            if n <= nmax:
                dstack[n] = d          # D_n (before stepping to D_{n-1})
            d = n / mx - 1.0 / (d + n / mx)
        # psi/chi upward
        pa, pb = np.cos(x), np.sin(x)       # psi_{-1}, psi_0
        ca, cb = -np.sin(x), np.cos(x)
        qext = np.zeros_like(x)
        qsca = np.zeros_like(x)
        gsum = np.zeros_like(x)
        absum = np.zeros_like(x)
        an_prev = np.zeros_like(mx)
        bn_prev = np.zeros_like(mx)
        for n in range(1, nmax + 1):
            pn = (2 * n - 1) / x * pb - pa
            cn = (2 * n - 1) / x * cb - ca
            psi_n, psi_nm1 = pn, pb
            xi_n = pn - 1j * cn
            xi_nm1 = pb - 1j * cb
            dn = dstack[n]
            fa = dn / m + n / x
            fb = dn * m + n / x
            an = (fa * psi_n - psi_nm1) / (fa * xi_n - xi_nm1)
            bn = (fb * psi_n - psi_nm1) / (fb * xi_n - xi_nm1)
            live = n <= nmax_each
            an = np.where(live & np.isfinite(an), an, 0.0)
            bn = np.where(live & np.isfinite(bn), bn, 0.0)
            qext += (2 * n + 1) * (an.real + bn.real)
            qsca += (2 * n + 1) * (np.abs(an) ** 2 + np.abs(bn) ** 2)
            absum += (2 * n + 1) / (n * (n + 1.0)) * (an * np.conj(bn)).real
            if n > 1:
                nm = n - 1
                gsum += (
                    nm * (nm + 2.0) / (nm + 1.0)
                    * (an_prev * np.conj(an) + bn_prev * np.conj(bn)).real
                )
            an_prev, bn_prev = an, bn
            pa, pb = pb, pn
            ca, cb = cb, cn

    x2 = np.maximum(x, 1e-12) ** 2
    qe = 2.0 / x2 * qext
    qs = 2.0 / x2 * qsca
    g = np.where(qs > 0, 4.0 / x2 * (gsum + absum) / np.maximum(qs, 1e-300), 0.0)
    return qe, qs, g


def mie_q_and_g(x: float, m: complex) -> tuple[float, float, float]:
    """Single-sphere convenience wrapper around mie_batch."""
    if x <= 0:
        return 0.0, 0.0, 0.0
    qe, qs, g = mie_batch(np.array([x]), m)
    return float(qe[0]), float(qs[0]), float(g[0])


def gamma_quadrature(re: float, veff: float = VEFF, nr: int = 32):
    """Radius nodes/weights (area-weighted use later) for a gamma
    distribution n(r) ~ r^((1-3v)/v) exp(-r/(re v))."""
    alpha = (1.0 - 3.0 * veff) / veff
    scale = re * veff
    # sample where the area-weighted density r^2 n(r) has mass
    lo = max(re * 0.02, 0.02)
    hi = re * (1.0 + 8.0 * np.sqrt(veff))
    r = np.linspace(lo, hi, nr)
    w = r ** alpha * np.exp(-r / scale)
    w /= np.trapezoid(w, r)
    return r, w


def droplet_properties(re: float, wl: float, m: complex):
    """Distribution-averaged (k_ext [m^2/g LWP], w0, g) at one (re, wl)."""
    r, w = gamma_quadrature(re)
    x = 2.0 * np.pi * r / wl
    qe, qs, gg = mie_batch(x, m)
    a2 = w * r**2
    ext = np.trapezoid(qe * a2, r)
    sca = np.trapezoid(qs * a2, r)
    gsc = np.trapezoid(gg * qs * a2, r)
    vol = np.trapezoid(w * r**3, r)
    k_ext = 0.75 * ext / vol          # m^2/g for water density 1 g/cm^3
    w0 = sca / ext if ext > 0 else 0.0
    g = gsc / sca if sca > 0 else 0.0
    return k_ext, w0, g


def generate_tables(progress: bool = False) -> dict:
    """Build the full (phase x re x wl) tables for water and ice."""
    out = {}
    for phase, indexer in (("water", water_index), ("ice", ice_index)):
        ke = np.zeros((len(RE_GRID), len(WL_GRID)))
        w0 = np.zeros_like(ke)
        gg = np.zeros_like(ke)
        midx = indexer(WL_GRID)
        for i, re in enumerate(RE_GRID):
            for j, wl in enumerate(WL_GRID):
                ke[i, j], w0[i, j], gg[i, j] = droplet_properties(
                    re, wl, complex(midx[j])
                )
            if progress:
                print(f"{phase} re={re}", flush=True)
        out[f"{phase}_kext"] = ke
        out[f"{phase}_w0"] = w0
        out[f"{phase}_g"] = gg
    out["re"] = RE_GRID
    out["wl"] = WL_GRID
    return out


@functools.lru_cache(maxsize=1)
def tables() -> dict:
    if os.path.exists(_NPZ):
        with np.load(_NPZ) as z:
            return {k: z[k] for k in z.files}
    t = generate_tables()
    np.savez_compressed(_NPZ, **t)
    return t


# --------------------------------------------------------------------------
# True phase-function Legendre moments (imomc=4): the disort.f:GETMOM-class
# "real Mie moments" path, beyond the Henyey-Greenstein default.
# --------------------------------------------------------------------------

MOM_RE_GRID = np.array([2.0, 4.0, 8.0, 16.0, 32.0])
MOM_WL_GRID = np.geomspace(0.4, 4.0, 16)
MOM_NMOM = 65
_MOM_NPZ = os.path.join(os.path.dirname(__file__), "mie_moments.npz")


def _theta_grid(n_core: int = 2600, n_peak: int = 500) -> np.ndarray:
    """Composite scattering-angle grid resolving the forward diffraction
    peak (log-spaced down to 1e-5 rad) plus a uniform backbone."""
    peak = np.geomspace(1e-5, 0.15, n_peak)
    core = np.linspace(0.15, np.pi, n_core)
    return np.unique(np.concatenate([[0.0], peak, core]))


def mie_phase_function(x: np.ndarray, m: complex, theta: np.ndarray):
    """Distribution-member phase functions P(theta) for sizes `x`.

    Returns (p [nx, ntheta] normalized so (1/2) int P dmu = 1, qsca [nx]).
    Standard amplitude series: S1 = sum c_n (a_n pi_n + b_n tau_n),
    S2 = sum c_n (a_n tau_n + b_n pi_n), c_n = (2n+1)/(n(n+1)).
    """
    x = np.asarray(x, np.float64)
    mu = np.cos(theta)                                  # [nt]
    nmax_each = (x + 4.05 * np.cbrt(x) + 2.0).astype(int)
    nmax = int(nmax_each.max())
    nmx = nmax + 16
    mx = m * x

    with np.errstate(all="ignore"):
        d = np.zeros_like(mx)
        dstack = np.empty((nmax + 1,) + x.shape, complex)
        for n in range(nmx, 0, -1):
            if n <= nmax:
                dstack[n] = d
            d = n / mx - 1.0 / (d + n / mx)
        pa, pb = np.cos(x), np.sin(x)
        ca, cb = -np.sin(x), np.cos(x)
        s1 = np.zeros((len(x), len(mu)), complex)
        s2 = np.zeros((len(x), len(mu)), complex)
        qsca = np.zeros_like(x)
        pi_nm1 = np.zeros_like(mu)                       # pi_0
        pi_n = np.ones_like(mu)                          # pi_1
        for n in range(1, nmax + 1):
            pn = (2 * n - 1) / x * pb - pa
            cn = (2 * n - 1) / x * cb - ca
            psi_n, psi_nm1 = pn, pb
            xi_n = pn - 1j * cn
            xi_nm1 = pb - 1j * cb
            dn = dstack[n]
            fa = dn / m + n / x
            fb = dn * m + n / x
            an = (fa * psi_n - psi_nm1) / (fa * xi_n - xi_nm1)
            bn = (fb * psi_n - psi_nm1) / (fb * xi_n - xi_nm1)
            live = n <= nmax_each
            an = np.where(live & np.isfinite(an), an, 0.0)
            bn = np.where(live & np.isfinite(bn), bn, 0.0)
            qsca += (2 * n + 1) * (np.abs(an) ** 2 + np.abs(bn) ** 2)
            tau_n = n * mu * pi_n - (n + 1) * pi_nm1
            cf = (2 * n + 1) / (n * (n + 1.0))
            s1 += cf * (an[:, None] * pi_n[None, :] + bn[:, None] * tau_n[None, :])
            s2 += cf * (an[:, None] * tau_n[None, :] + bn[:, None] * pi_n[None, :])
            pi_np1 = ((2 * n + 1) * mu * pi_n - (n + 1) * pi_nm1) / n
            pi_nm1, pi_n = pi_n, pi_np1
            pa, pb = pb, pn
            ca, cb = cb, cn

    intens = np.abs(s1) ** 2 + np.abs(s2) ** 2           # [nx, nt]
    # normalize each size's P numerically: (1/2) int P dmu = 1
    norm = -0.5 * np.trapezoid(intens, mu, axis=1)       # mu descending in theta
    p = intens / np.maximum(norm[:, None], 1e-300)
    qsca = np.maximum(2.0 / np.maximum(x, 1e-12) ** 2 * qsca, 1e-300)
    return p, qsca


def droplet_moments(re: float, wl: float, m: complex,
                    nmom: int = MOM_NMOM) -> np.ndarray:
    """Gamma-distribution-averaged phase-function Legendre moments g_l
    (g_0 = 1, DISORT convention P = sum (2l+1) g_l P_l)."""
    theta = _theta_grid()
    mu = np.cos(theta)
    r, w = gamma_quadrature(re)
    x = 2.0 * np.pi * r / wl
    p, qsca = mie_phase_function(x, m, theta)
    # scattering-cross-section weighting over the size distribution
    wgt = w * r ** 2 * qsca
    p_avg = np.einsum("s,st->t", wgt, p) / np.maximum(wgt.sum(), 1e-300)
    # project: g_l = (1/2) int P(mu) P_l(mu) dmu  (recurrence for P_l)
    g = np.empty(nmom)
    pl_m1 = np.ones_like(mu)
    pl = mu.copy()
    g[0] = -0.5 * np.trapezoid(p_avg * pl_m1, mu)
    if nmom > 1:
        g[1] = -0.5 * np.trapezoid(p_avg * pl, mu)
    for l in range(2, nmom):
        pl_p1 = ((2 * l - 1) * mu * pl - (l - 1) * pl_m1) / l
        pl_m1, pl = pl, pl_p1
        g[l] = -0.5 * np.trapezoid(p_avg * pl, mu)
    return g / g[0]


def generate_moment_tables(progress: bool = False) -> dict:
    out = {"mom_re": MOM_RE_GRID, "mom_wl": MOM_WL_GRID}
    for phase, indexer in (("water", water_index), ("ice", ice_index)):
        midx = indexer(MOM_WL_GRID)
        mom = np.zeros((len(MOM_RE_GRID), len(MOM_WL_GRID), MOM_NMOM))
        for i, re in enumerate(MOM_RE_GRID):
            for j, wl in enumerate(MOM_WL_GRID):
                mom[i, j] = droplet_moments(re, wl, complex(midx[j]))
            if progress:
                print(f"moments {phase} re={re}", flush=True)
        out[f"{phase}_mom"] = mom
    return out


@functools.lru_cache(maxsize=1)
def moment_tables() -> dict:
    if os.path.exists(_MOM_NPZ):
        with np.load(_MOM_NPZ) as z:
            return {k: z[k] for k in z.files}
    t = generate_moment_tables()
    np.savez_compressed(_MOM_NPZ, **t)
    return t


def cloud_moments(re, wl_um, nmom: int, phase: str = "water") -> np.ndarray:
    """True Mie phase-function moments g_l at (re, wl), bilinear in log.

    Valid for re in [2, 32] um and wl in [0.4, 4] um (the SW radiance
    regime the table covers); out-of-range (re, wl) raise so imomc=4 never
    silently extrapolates.
    """
    t = moment_tables()
    re_a = np.atleast_1d(np.asarray(re, np.float64))
    wl_a = np.atleast_1d(np.asarray(wl_um, np.float64))
    if (re_a < MOM_RE_GRID[0] - 1e-9).any() or (re_a > MOM_RE_GRID[-1] + 1e-9).any():
        raise ValueError(
            f"imomc/imoma=4 Mie-moment table covers re in "
            f"[{MOM_RE_GRID[0]}, {MOM_RE_GRID[-1]}] um; got {re}"
        )
    if (wl_a < MOM_WL_GRID[0] - 1e-9).any() or (wl_a > MOM_WL_GRID[-1] + 1e-9).any():
        raise ValueError(
            f"imomc/imoma=4 Mie-moment table covers wl in "
            f"[{MOM_WL_GRID[0]:.2f}, {MOM_WL_GRID[-1]:.2f}] um; got range "
            f"[{wl_a.min():.3f}, {wl_a.max():.3f}]"
        )
    if nmom > MOM_NMOM:
        raise ValueError(f"nmom={nmom} exceeds the {MOM_NMOM}-moment table")
    gr = np.log(t["mom_re"])
    gw = np.log(t["mom_wl"])
    lre = np.log(np.clip(re_a, t["mom_re"][0], t["mom_re"][-1]))
    lwl = np.log(np.clip(wl_a, t["mom_wl"][0], t["mom_wl"][-1]))
    i = np.clip(np.searchsorted(gr, lre) - 1, 0, len(gr) - 2)
    j = np.clip(np.searchsorted(gw, lwl) - 1, 0, len(gw) - 2)
    fr = ((lre - gr[i]) / (gr[i + 1] - gr[i]))[..., None]
    fw = ((lwl - gw[j]) / (gw[j + 1] - gw[j]))[..., None]
    a = t[f"{phase}_mom"][..., :nmom]
    mom = (
        a[i, j] * (1 - fr) * (1 - fw) + a[i + 1, j] * fr * (1 - fw)
        + a[i, j + 1] * (1 - fr) * fw + a[i + 1, j + 1] * fr * fw
    )
    return mom


def cloud_properties(re, wl_um, phase: str = "water"):
    """Bilinear-in-log interpolation of (k_ext, w0, g) at (re, wl).

    re, wl_um broadcast; returns (k_ext [m^2/g], w0, g).
    """
    t = tables()
    lre = np.log(np.clip(np.asarray(re, np.float64), RE_GRID[0], RE_GRID[-1]))
    lwl = np.log(np.clip(np.asarray(wl_um, np.float64), WL_GRID[0], WL_GRID[-1]))
    gr = np.log(t["re"])
    gw = np.log(t["wl"])
    i = np.clip(np.searchsorted(gr, lre) - 1, 0, len(gr) - 2)
    j = np.clip(np.searchsorted(gw, lwl) - 1, 0, len(gw) - 2)
    fr = (lre - gr[i]) / (gr[i + 1] - gr[i])
    fw = (lwl - gw[j]) / (gw[j + 1] - gw[j])

    def bilin(a):
        return (
            a[i, j] * (1 - fr) * (1 - fw)
            + a[i + 1, j] * fr * (1 - fw)
            + a[i, j + 1] * (1 - fr) * fw
            + a[i + 1, j + 1] * fr * fw
        )

    return (
        bilin(t[f"{phase}_kext"]),
        bilin(t[f"{phase}_w0"]),
        bilin(t[f"{phase}_g"]),
    )
