"""B1: the fused nstr=4 front end (delta-M + scattering build + beam RHS +
closed-form n = 2 eigen chain + beam solve + transmissions), and B8: the
same chain and beam solve on prebuilt scattering matrices.

Port of sbdart_tpu/pallas/eig.py:_n2_deltam_scatter_kernel (reached via
eig_beam_deltam_scatter_n2_layered).  `eig_beam_deltam_scatter_n2` launches
the CUDA kernel csrc/eig_n2_deltam.cu on CUDA tensors and runs
`eig_beam_deltam_scatter_n2_plain`, the same math in plain torch with the
same operation order, on CPU tensors.

Layout is column-minor: dtau/ssalb [L, B], pmom [L, 5, B], scale/mu0
[1, B]; outputs kk [L, 2, B], gp/gm [L, 2, 2, B], zp/zm [L, 2, B],
dtau* [L, B], ee [L, 2, B].  Eigenpairs come out in the chain's own
`wa <= wb` order (no sort): compare per-mode tensors only against the
same route.

B8 is the port of sbdart_tpu/pallas/eig.py:_n2_planar_kernel, which the
radiance path runs at nstr=4 on every (mode, layer, column) lane
(`eig_beam_chain_n2`, csrc/eig_n2_planar.cu).  B1, B3 and B8 share one
chain: `_n2_chain` here, `n2_chain` in csrc/eig_n2_chain.cuh.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import numpy as np
import torch

from sbdart_tpu_torch import tracing
from sbdart_tpu_torch.kernels import use_kernel
from sbdart_tpu_torch.solver.deltam import ssalb_dither


def _consts(tab, dtype: torch.dtype) -> dict:
    """Static coefficients of the chain, as float64 Python numbers (they
    round to the working dtype where they meet a tensor)."""
    mu = np.asarray(tab.mu, np.float64)
    w = np.asarray(tab.w, np.float64)
    ylm0 = np.asarray(tab.ylm[0], np.float64)        # [4, 2] Lam_l(mu_i)
    par0 = np.asarray(tab.parity[0], np.float64)     # [4]    (-1)^l
    p = np.sqrt(mu * w)
    ij = [(0, 0), (0, 1), (1, 0), (1, 1)]
    # division by a constant runs as a multiply by its reciprocal, taken
    # in the working dtype (as XLA and torch's CUDA division by a scalar
    # both do), so every route rounds the same way
    npt = np.float32 if dtype == torch.float32 else np.float64
    return dict(
        mu=mu, w=w, p=p, p12=p[0] / p[1], p21=p[1] / p[0],
        inv_mu=npt(1.0) / mu.astype(npt), inv_p=npt(1.0) / p.astype(npt),
        ridge=8.0 * float(torch.finfo(dtype).eps) / 2.0,
        cpp=np.array([[ylm0[l, i] * ylm0[l, j] for l in range(4)]
                      for i, j in ij]),
        cpm=np.array([[par0[l] * ylm0[l, i] * ylm0[l, j] for l in range(4)]
                      for i, j in ij]),
        ylm=ylm0, ylmpar=par0[:, None] * ylm0, par=par0,
        ss_hi=1.0 - ssalb_dither(dtype), f_hi=1.0 - 1e-6, kk_floor=1e-30,
    )


@functools.lru_cache(maxsize=8)
def _kernel_consts(mu, w, ylm0, par0) -> np.ndarray:
    """The kernel's EigN2Consts struct, field by field, as float32, for the
    tables given as tuples (mu, w, ylm[0] raveled, parity[0])."""
    tab = SimpleNamespace(mu=np.array(mu), w=np.array(w),
                          ylm=np.array(ylm0).reshape(1, 4, 2),
                          parity=np.array(par0).reshape(1, 4))
    c = _consts(tab, torch.float32)
    flat = np.concatenate([
        c["inv_mu"], c["w"], c["inv_p"], [c["p12"], c["p21"], c["ridge"]],
        c["cpp"].ravel(), c["cpm"].ravel(), c["ylm"].ravel(),
        c["ylmpar"].ravel(), c["par"], [c["ss_hi"], c["f_hi"], c["kk_floor"]],
    ]).astype(np.float32)
    assert flat.size == 64
    flat.flags.writeable = False
    return flat


def eigh2_half_angle(m11, q12, m22):
    """Closed-form symmetric 2x2 eigendecomposition of [[m11, q12], [q12,
    m22]] by half-angle algebra (pallas/eig.py:_eigh2_inline), with the
    `wa <= wb` select and no sort.  Returns (k2_1, k2_2, v11, v12, v21,
    v22), eigenvector columns (v11, v21) and (v12, v22).  Shared by the
    n = 2 chain here and the general chain at N = 2 (kernels/eig_chain.py;
    csrc/eig_n2_chain.cuh:eigh2_half_angle on the card)."""
    diff = m11 - m22
    rr = torch.sqrt(diff * diff + 4.0 * q12 * q12)
    safe = rr > 0.0
    rs = torch.where(safe, rr, 1.0)
    cos2 = torch.where(safe, diff / rs, 1.0)
    sin2 = torch.where(safe, 2.0 * q12 / rs, 0.0)
    cth = torch.sqrt(torch.clamp_min(0.5 * (1.0 + cos2), 0.0))
    sabs = torch.sqrt(torch.clamp_min(0.5 * (1.0 - cos2), 0.0))
    sth = torch.where(sin2 >= 0.0, sabs, -sabs)
    wa = cth * cth * m11 + 2.0 * cth * sth * q12 + sth * sth * m22
    wb = sth * sth * m11 - 2.0 * cth * sth * q12 + cth * cth * m22
    lo = wa <= wb
    return (torch.where(lo, wa, wb), torch.where(lo, wb, wa),
            torch.where(lo, cth, -sth), torch.where(lo, -sth, cth),
            torch.where(lo, sth, cth), torch.where(lo, cth, sth))


def _n2_chain(c, cpp, cpm, r1a, r1b, r2a, r2b, mu0p):
    """Closed-form n = 2 chain (pallas/eig.py:_n2_chain_planar) on
    per-entry tensors.  Returns (kk1, kk2), gp [4], gm [4], zp [2], zm [2]."""
    imu1, imu2 = float(c["inv_mu"][0]), float(c["inv_mu"][1])
    w1, w2 = float(c["w"][0]), float(c["w"][1])
    ip1, ip2 = float(c["inv_p"][0]), float(c["inv_p"][1])
    p12, p21 = float(c["p12"]), float(c["p21"])

    amb11 = (1.0 - (cpp[0] + cpm[0]) * w1) * imu1
    amb12 = (-(cpp[1] + cpm[1]) * w2) * imu1
    amb21 = (-(cpp[2] + cpm[2]) * w1) * imu2
    amb22 = (1.0 - (cpp[3] + cpm[3]) * w2) * imu2
    apb11 = (1.0 - (cpp[0] - cpm[0]) * w1) * imu1
    apb12 = (-(cpp[1] - cpm[1]) * w2) * imu1
    apb21 = (-(cpp[2] - cpm[2]) * w1) * imu2
    apb22 = (1.0 - (cpp[3] - cpm[3]) * w2) * imu2

    # symmetrized congruence P M P^-1, P = diag(sqrt(mu w))
    sm11, sm22 = amb11, amb22
    sm12 = 0.5 * (amb12 * p12 + amb21 * p21)
    sp11, sp22 = apb11, apb22
    sp12 = 0.5 * (apb12 * p12 + apb21 * p21)

    # trace ridge (8 eps / n) tr on the diagonal
    tr = sm11 + sm22
    ridge = c["ridge"] * tr
    sm11 = sm11 + ridge
    sm22 = sm22 + ridge

    # Cholesky of S-
    l11 = torch.sqrt(sm11)
    l21 = sm12 / l11
    l22 = torch.sqrt(sm22 - l21 * l21)

    # M = L^T S+ L
    a11 = sp11 * l11 + sp12 * l21
    a12 = sp12 * l22
    a21 = sp12 * l11 + sp22 * l21
    a22 = sp22 * l22
    m11 = l11 * a11 + l21 * a21
    m12v = l11 * a12 + l21 * a22
    m21v = l22 * a21
    m22 = l22 * a22
    q12 = 0.5 * (m12v + m21v)

    # half-angle symmetric 2x2 eigendecomposition, `wa <= wb` select only
    k2_1, k2_2, v11, v12, v21, v22 = eigh2_half_angle(m11, q12, m22)
    kk1 = torch.sqrt(torch.clamp_min(k2_1, c["kk_floor"]))
    kk2 = torch.sqrt(torch.clamp_min(k2_2, c["kk_floor"]))

    # z = (L^T)^-1 v, x = P^-1 z
    z21 = v21 / l22
    z22 = v22 / l22
    z11 = (v11 - l21 * z21) / l11
    z12 = (v12 - l21 * z22) / l11
    x11 = z11 * ip1
    x12 = z12 * ip1
    x21 = z21 * ip2
    x22 = z22 * ip2

    # y = -(amb x) / kk_j ; G+- = (x +- y) / 2
    y11 = -(amb11 * x11 + amb12 * x21) / kk1
    y12 = -(amb11 * x12 + amb12 * x22) / kk2
    y21 = -(amb21 * x11 + amb22 * x21) / kk1
    y22 = -(amb21 * x12 + amb22 * x22) / kk2
    gp = [0.5 * (x11 + y11), 0.5 * (x12 + y12),
          0.5 * (x21 + y21), 0.5 * (x22 + y22)]
    gm = [0.5 * (x11 - y11), 0.5 * (x12 - y12),
          0.5 * (x21 - y21), 0.5 * (x22 - y22)]

    # beam particular: [(a+b)(a-b) - I/mu0^2] S = (a+b) r1 - r2/mu0
    inv0 = 1.0 / mu0p
    inv0sq = inv0 * inv0
    b11 = apb11 * amb11 + apb12 * amb21 - inv0sq
    b12 = apb11 * amb12 + apb12 * amb22
    b21 = apb21 * amb11 + apb22 * amb21
    b22 = apb21 * amb12 + apb22 * amb22 - inv0sq
    rb1 = apb11 * r1a + apb12 * r1b - r2a * inv0
    rb2 = apb21 * r1a + apb22 * r1b - r2b * inv0
    # partial-pivoted 2x2 elimination
    swap = torch.abs(b21) > torch.abs(b11)
    t11 = torch.where(swap, b21, b11)
    t12 = torch.where(swap, b22, b12)
    tr1 = torch.where(swap, rb2, rb1)
    t21 = torch.where(swap, b11, b21)
    t22 = torch.where(swap, b12, b22)
    tr2 = torch.where(swap, rb1, rb2)
    f = t21 / t11
    d22 = t22 - f * t12
    s2 = (tr2 - f * tr1) / d22
    s1 = (tr1 - t12 * s2) / t11
    d1 = (r1a - (amb11 * s1 + amb12 * s2)) * mu0p
    d2 = (r1b - (amb21 * s1 + amb22 * s2)) * mu0p
    zp = [0.5 * (s1 + d1), 0.5 * (s2 + d2)]
    zm = [0.5 * (s1 - d1), 0.5 * (s2 - d2)]
    return (kk1, kk2), gp, gm, zp, zm


def eig_beam_deltam_scatter_n2_plain(dtau, ssalb, pmom5, scale, mu0, tab,
                                     use_deltam=True):
    """Plain torch version of the B1 kernel, any device and float dtype."""
    return _front(_consts(tab, dtau.dtype), dtau, ssalb, pmom5, scale, mu0,
                  use_deltam)


def _front(c, dtau, ssalb, pmom5, scale, mu0, use_deltam):
    """B1's math with the static coefficients `c` (see _consts)."""
    b = dtau.shape[1]
    ss_raw = torch.clamp(ssalb, 0.0, c["ss_hi"])
    pm = [pmom5[:, q] for q in range(5)]
    mu0p = mu0.reshape(1, b)
    scl = scale.reshape(1, b)

    if use_deltam:
        f = torch.clamp(pm[4], 0.0, c["f_hi"])
        wf = ss_raw * f
        dts = (1.0 - wf) * dtau
        ss = torch.clamp(ss_raw * (1.0 - f) / (1.0 - wf), 0.0, c["ss_hi"])
        inv1mf = 1.0 / (1.0 - f)
        gl = [(pm[q] - f) * inv1mf for q in range(4)]
    else:
        dts = dtau
        ss = ss_raw
        gl = pm[:4]

    kk, gp, gm, zp, zm = _scatter_chain(c, ss, gl, scl, mu0p)
    ee = torch.exp(-kk * dts[:, None, :])
    return kk, gp, gm, zp, zm, dts, ee


def _scatter_chain(c, ss, gl, scl, mu0p):
    """Scattering build + beam RHS + n = 2 chain + beam solve, shared by
    B1 and B3 (pallas/eig.py:792-832): delta-M-scaled ssalb [L, B] and
    moments gl (4 planes [L, B]), scale/mu0 [1, B] -> kk [L, 2, B],
    gp/gm [L, 2, 2, B], zp/zm [L, 2, B]."""
    nlyr, b = ss.shape
    cl = [0.5 * float(2 * q + 1) * ss * gl[q] for q in range(4)]
    cpp, cpm = [], []
    for ij in range(4):
        sp = float(c["cpp"][ij, 0]) * cl[0]
        sm = float(c["cpm"][ij, 0]) * cl[0]
        for q in range(1, 4):
            sp = sp + float(c["cpp"][ij, q]) * cl[q]
            sm = sm + float(c["cpm"][ij, q]) * cl[q]
        cpp.append(sp)
        cpm.append(sm)
    # Lam_l(mu0) at m = 0: the Legendre polynomials
    y0 = [torch.ones_like(mu0p), mu0p,
          0.5 * (3.0 * mu0p * mu0p - 1.0),
          0.5 * mu0p * (5.0 * mu0p * mu0p - 3.0)]
    prod = [cl[q] * (float(c["par"][q]) * y0[q]) for q in range(4)]
    x0p, x0m = [], []
    for i in range(2):
        sp = float(c["ylm"][0, i]) * prod[0]
        sm = float(c["ylmpar"][0, i]) * prod[0]
        for q in range(1, 4):
            sp = sp + float(c["ylm"][q, i]) * prod[q]
            sm = sm + float(c["ylmpar"][q, i]) * prod[q]
        x0p.append(sp * scl)
        x0m.append(sm * scl)
    imu1, imu2 = float(c["inv_mu"][0]), float(c["inv_mu"][1])
    r1a = (x0p[0] + x0m[0]) * imu1
    r1b = (x0p[1] + x0m[1]) * imu2
    r2a = (x0p[0] - x0m[0]) * imu1
    r2b = (x0p[1] - x0m[1]) * imu2

    return _stack(nlyr, b, _n2_chain(c, cpp, cpm, r1a, r1b, r2a, r2b, mu0p))


def _stack(nlyr, b, chain):
    """_n2_chain's per-entry planes [L, B] -> kk [L, 2, B], gp/gm
    [L, 2, 2, B], zp/zm [L, 2, B]."""
    kk, gp, gm, zp, zm = chain
    return (torch.stack(kk, dim=1),
            torch.stack(gp, dim=1).reshape(nlyr, 2, 2, b),
            torch.stack(gm, dim=1).reshape(nlyr, 2, 2, b),
            torch.stack(zp, dim=1), torch.stack(zm, dim=1))


_ENTRIES = ((0, 0), (0, 1), (1, 0), (1, 1))


def eig_beam_chain_n2_plain(cppl, cpml, r1, r2, mu0, tab):
    """Plain torch version of the B8 kernel, any device and float dtype:
    the n = 2 chain (`_n2_chain`) on prebuilt C^pp / C^pm."""
    nlyr, _, _, b = cppl.shape
    cpp = [cppl[:, i, j] for i, j in _ENTRIES]
    cpm = [cpml[:, i, j] for i, j in _ENTRIES]
    return _stack(nlyr, b, _n2_chain(
        _consts(tab, cppl.dtype), cpp, cpm, r1[:, 0], r1[:, 1], r2[:, 0],
        r2[:, 1], mu0.reshape(1, b)))


def eig_beam_chain_n2(cppl, cpml, r1, r2, mu0, tab):
    """B8: the n = 2 chain + beam solve on prebuilt C^pp / C^pm [L, 2, 2,
    B], r1/r2 [L, 2, B] and mu0 [1, B] (shared by the layers), as
    pallas/eig.py:_n2_planar_kernel.  The CUDA kernel csrc/eig_n2_planar.cu
    on CUDA tensors (float32 only), the plain torch version on CPU
    tensors.  Returns kk [L, 2, B], gp/gm [L, 2, 2, B], zp/zm [L, 2, B]."""
    if not use_kernel(cppl):
        return eig_beam_chain_n2_plain(cppl, cpml, r1, r2, mu0, tab)
    from sbdart_tpu_torch.kernels import _build

    nlyr, _, _, b = cppl.shape
    want = {"cppl": (nlyr, 2, 2, b), "cpml": (nlyr, 2, 2, b),
            "r1": (nlyr, 2, b), "r2": (nlyr, 2, b)}
    for name, t in zip(want, (cppl, cpml, r1, r2)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"eig_beam_chain_n2: {name} has shape "
                             f"{tuple(t.shape)}, expected {want[name]}")
    if mu0.numel() != b:
        raise ValueError("eig_beam_chain_n2: mu0 must be [1, B]")
    ins = [t.contiguous() for t in (cppl, cpml, r1, r2, mu0)]
    _build.require_cuda_f32("eig_beam_chain_n2", *ins)
    consts = _kernel_consts(
        tuple(tab.mu), tuple(tab.w), tuple(np.ravel(tab.ylm[0])),
        tuple(tab.parity[0]),
    )
    new = dict(device=cppl.device, dtype=torch.float32)
    outs = (torch.empty((nlyr, 2, b), **new),
            torch.empty((nlyr, 2, 2, b), **new),
            torch.empty((nlyr, 2, 2, b), **new),
            torch.empty((nlyr, 2, b), **new), torch.empty((nlyr, 2, b), **new))
    lib = _build.library()
    with torch.cuda.device(cppl.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.sbdart_eig_n2_planar(
            *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
            nlyr, b, consts.ctypes.data, stream,
        )
    tracing.count("kernels.eig_beam_chain_n2.launches")
    _build.check(code, "eig_beam_chain_n2")
    return outs


def eig_beam_deltam_scatter_n2(dtau, ssalb, pmom5, scale, mu0, tab,
                               use_deltam=True):
    """B1 front end: the CUDA kernel on CUDA tensors (float32 only), the
    plain torch version on CPU tensors.  Shapes as in the module doc."""
    if not use_kernel(dtau):
        return eig_beam_deltam_scatter_n2_plain(
            dtau, ssalb, pmom5, scale, mu0, tab, use_deltam
        )
    from sbdart_tpu_torch.kernels import _build

    nlyr, b = dtau.shape
    if ssalb.shape != (nlyr, b) or pmom5.shape != (nlyr, 5, b):
        raise ValueError(
            f"eig_beam_deltam_scatter_n2: shapes dtau {tuple(dtau.shape)}, "
            f"ssalb {tuple(ssalb.shape)}, pmom5 {tuple(pmom5.shape)}"
        )
    if scale.numel() != b or mu0.numel() != b:
        raise ValueError("eig_beam_deltam_scatter_n2: scale/mu0 must be [1, B]")
    ins = [x.contiguous() for x in (dtau, ssalb, pmom5, scale, mu0)]
    _build.require_cuda_f32("eig_beam_deltam_scatter_n2", *ins)
    consts = _kernel_consts(
        tuple(tab.mu), tuple(tab.w), tuple(np.ravel(tab.ylm[0])),
        tuple(tab.parity[0]),
    )
    new = dict(device=dtau.device, dtype=torch.float32)
    kk = torch.empty((nlyr, 2, b), **new)
    gp = torch.empty((nlyr, 2, 2, b), **new)
    gm = torch.empty((nlyr, 2, 2, b), **new)
    zp = torch.empty((nlyr, 2, b), **new)
    zm = torch.empty((nlyr, 2, b), **new)
    dts = torch.empty((nlyr, b), **new)
    ee = torch.empty((nlyr, 2, b), **new)
    outs = (kk, gp, gm, zp, zm, dts, ee)
    lib = _build.library()
    with torch.cuda.device(dtau.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.sbdart_eig_n2_deltam(
            *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
            nlyr, b, int(bool(use_deltam)), consts.ctypes.data, stream,
        )
    tracing.count("kernels.eig_beam_deltam_scatter_n2.launches")
    _build.check(code, "eig_beam_deltam_scatter_n2")
    return outs
