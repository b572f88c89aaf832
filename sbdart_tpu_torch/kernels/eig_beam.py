"""B4: the general-n eigen chain + beam solve (nstr 8/12/16, N = 4, 6, 8).

Port of sbdart_tpu/pallas/eig.py:_kernel_beam (reached via
eig_beam_chain_lane_fused_layered).  Per (layer, column): alpha -+ beta
from C^pp/C^pm, the sqrt(mu w) congruence and symmetrization, the trace
ridge, Cholesky of S-, L^T S+ L, parallel-ordered cyclic Jacobi (a fixed
sweep count, round-robin pair schedule, no eigenvalue sort), the
triangular solve to G+-, and the reduced beam system

    [(a+b)(a-b) - I/mu0^2] S = (a+b) r1 - r2/mu0
    D = (r1 - (a-b) S) mu0 ;  Z+- = (S +- D)/2

solved by shrinking implicit-pivot elimination (kernels/blocktri_rt.py:
solve_step).  `eig_beam_chain` launches the CUDA kernel csrc/eig_beam.cu
on CUDA tensors and runs `eig_beam_chain_plain` on CPU tensors.

`eig_beam_chain_lane` is the flat entry of the radiance path
(pallas/eig.py:473-501), a one-layer view of the same kernel.

Layout is layer-leading and column-minor: cppl/cpml [L, N, N, B], r1/r2
[L, N, B], mu0 [1, B]; outputs kk [L, N, B], gp/gm [L, N, N, B], zp/zm
[L, N, B].  Eigenpairs come out in the Jacobi's own order (no sort):
compare per-mode tensors only against the same route.

The plain version takes every sum over a matrix index in order (k = 0,
1, ...) and divides by a tensor or multiplies by a reciprocal constant,
never divides by a Python number; the kernel does the same, term by term,
so the two agree to rounding on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sbdart_tpu_torch.kernels.blocktri_rt import solve_step
from sbdart_tpu_torch.kernels.eig_n2 import (
    eig_beam_chain_n2,
    eig_beam_chain_n2_plain,
)
from sbdart_tpu_torch.ops.lane import lmatmul as _mm
from sbdart_tpu_torch.ops.lane import lmatvec as _mv

# Jacobi sweeps of the float32 kernel (kSweeps in csrc/eig_beam.cu), the
# reference's DEFAULT_SWEEPS (pallas/eig.py:378-392, measured converged at
# 3).  The float64 route runs the reference lane route's 6 (ops/lane.py:260).
SWEEPS_F32 = 3
SWEEPS_F64 = 6


def _round_robin_pairs(n: int) -> list[list[tuple[int, int]]]:
    """Tournament schedule (ops/lane.py:190): n-1 rounds of n/2 disjoint
    (p, q) pairs covering every unordered pair once."""
    players = list(range(n))
    rounds = []
    for _ in range(n - 1):
        rounds.append([
            tuple(sorted((players[i], players[n - 1 - i])))
            for i in range(n // 2)
        ])
        players = [players[0]] + [players[-1]] + players[1:-1]
    return rounds


def _jacobi_tables(n: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """Per round: partner[i] and sgn[i] (-1 for p, +1 for q of each pair),
    as pallas/eig.py:_jacobi_rounds."""
    tables = []
    for pairs in _round_robin_pairs(n):
        partner = np.empty(n, np.int64)
        sgn = np.empty(n, np.float64)
        for p, q in pairs:
            partner[p], partner[q] = q, p
            sgn[p], sgn[q] = -1.0, 1.0
        tables.append((partner, sgn))
    return tables


def _consts(mu, w, dtype: torch.dtype) -> dict:
    """Static coefficients as float64 numbers: each rounds to the working
    dtype where it meets a tensor, as the reference's Python-float
    constants do."""
    mu = np.asarray(mu, np.float64)
    w = np.asarray(w, np.float64)
    n = len(mu)
    p = np.sqrt(mu * w)
    eps = float(torch.finfo(dtype).eps)
    return dict(n=n, inv_mu=1.0 / mu, w=w, p=p, inv_p=1.0 / p,
                eps=eps, ridge=8.0 * eps / n, kk_floor=1e-30,
                tables=_jacobi_tables(n))


@functools.lru_cache(maxsize=8)
def _kernel_consts(mu: tuple, w: tuple) -> np.ndarray:
    """The kernel's EigBeamConsts struct as 148 32-bit words: inv_mu, w, p,
    inv_p [8 each], ridge, eps, kk_floor, pad, partner [7][8] (int32),
    sgn [7][8]."""
    c = _consts(mu, w, torch.float32)
    n = c["n"]
    f = np.zeros(148, np.float32)
    for k, name in enumerate(("inv_mu", "w", "p", "inv_p")):
        f[8 * k:8 * k + n] = c[name]
    f[32:35] = (c["ridge"], c["eps"], c["kk_floor"])
    part = np.zeros((7, 8), np.int32)
    sgn = np.zeros((7, 8), np.float32)
    for r, (pt, sg) in enumerate(c["tables"]):
        part[r, :n] = pt
        sgn[r, :n] = sg
    f[36:92] = part.ravel().view(np.float32)
    f[92:148] = sgn.ravel()
    f.flags.writeable = False
    return f


def _vec(vals, like) -> torch.Tensor:
    """Constants as a [1, n, 1, 1] tensor for scaling rows (dim 1)."""
    return torch.tensor(vals, dtype=like.dtype,
                        device=like.device).reshape(1, -1, 1, 1)


def _sym(a):
    return 0.5 * (a + a.transpose(1, 2))


def _chol(a):
    """Lower Cholesky of SPD [L, n, n, B] (pallas/eig.py:_chol_inline)."""
    n = a.shape[1]
    zero = torch.zeros_like(a[:, 0, 0])
    rows = [[zero] * n for _ in range(n)]
    for j in range(n):
        s = a[:, j, j]
        for k in range(j):
            s = s - rows[j][k] * rows[j][k]
        d = torch.sqrt(s)
        rows[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s2 = a[:, i, j]
            for k in range(j):
                s2 = s2 - rows[i][k] * rows[j][k]
            rows[i][j] = s2 * inv_d
    return torch.stack([torch.stack(r, dim=1) for r in rows], dim=1)


def _jacobi(c, a, sweeps):
    """Parallel-ordered cyclic Jacobi on [L, n, n, B]
    (pallas/eig.py:_leigh_inline): per round, row-form rotation
    parameters, then the whole-matrix row pass, column pass and the
    eigenvector column pass.  Returns (w [L, n, B], v), unsorted."""
    n = a.shape[1]
    eps = c["eps"]
    v = torch.zeros_like(a) + torch.eye(
        n, dtype=a.dtype, device=a.device)[None, :, :, None]
    idx = torch.arange(n, device=a.device)
    rounds = [(torch.as_tensor(pt, device=a.device), _vec(-sg, a)[..., 0],
               _vec(sg, a)[..., 0]) for pt, sg in c["tables"]]
    for _ in range(sweeps):
        for partner, neg_sgn, sgn in rounds:
            d = a[:, idx, idx]                                  # [L, n, B]
            off = a[:, idx, partner]
            d_prm = d[:, partner]
            small = torch.abs(off) <= eps * torch.clamp_min(
                torch.abs(d) + torch.abs(d_prm), eps)
            tau = (neg_sgn * (d_prm - d)) / (
                2.0 * torch.where(small, 1.0, off))
            tsgn = torch.where(tau >= 0.0, 1.0, -1.0).to(a.dtype)
            t = tsgn / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
            t = torch.where(small, 0.0, t)
            crow = 1.0 / torch.sqrt(1.0 + t * t)
            srow = sgn * (t * crow)
            a = crow[:, :, None] * a + srow[:, :, None] * a[:, partner]
            a = crow[:, None, :] * a + srow[:, None, :] * a[:, :, partner]
            v = crow[:, None, :] * v + srow[:, None, :] * v[:, :, partner]
    return a[:, idx, idx], v


def _solve_ut(u, b):
    """U x = b, U upper-triangular [L, n, n, B], b [L, n, m, B]."""
    n = u.shape[1]
    x = [None] * n
    for i in reversed(range(n)):
        s = b[:, i]
        for k in range(i + 1, n):
            s = s - u[:, i, k, None, :] * x[k]
        x[i] = s / u[:, i, i, None, :]
    return torch.stack(x, dim=1)


def eig_beam_chain_plain(cppl, cpml, r1, r2, mu0, mu, w, sweeps=SWEEPS_F32):
    """Plain torch version of the B4 kernel, any device and float dtype.
    Shapes as in the module doc; `sweeps` Jacobi sweeps (the kernel's 3
    by default)."""
    c = _consts(mu, w, cppl.dtype)
    n = c["n"]
    eye = torch.eye(n, dtype=cppl.dtype, device=cppl.device)[None, :, :, None]
    inv_mu = _vec(c["inv_mu"], cppl)
    w_col = _vec(c["w"], cppl).transpose(1, 2)              # [1, 1, n, 1]
    amb = inv_mu * (eye - w_col * (cppl + cpml))
    apb = inv_mu * (eye - w_col * (cppl - cpml))

    p_row = _vec(c["p"], cppl)
    inv_p_col = _vec(c["inv_p"], cppl).transpose(1, 2)
    s_minus = _sym(inv_p_col * (p_row * amb))
    s_plus = _sym(inv_p_col * (p_row * apb))
    trace = s_minus[:, 0, 0]
    for i in range(1, n):
        trace = trace + s_minus[:, i, i]
    s_minus = s_minus + (c["ridge"] * trace)[:, None, None, :] * eye
    l = _chol(s_minus)
    lt = l.transpose(1, 2)
    k2, v = _jacobi(c, _sym(_mm(_mm(lt, s_plus), l)), sweeps)
    kk = torch.sqrt(torch.clamp_min(k2, c["kk_floor"]))

    x = _vec(c["inv_p"], cppl) * _solve_ut(lt, v)
    y = -_mm(amb, x) / kk[:, None, :, :]
    gp = 0.5 * (x + y)
    gm = 0.5 * (x - y)

    mu0 = mu0.reshape(1, -1)
    inv_mu0 = 1.0 / mu0
    mat = _mm(apb, amb) - eye * (inv_mu0 * inv_mu0)[:, None, None, :]
    rhs = _mv(apb, r1) - r2 * inv_mu0[:, None, :]
    s = solve_step(mat, rhs[:, :, None, :])[:, :, 0]
    d = (r1 - _mv(amb, s)) * mu0[:, None, :]
    return kk, gp, gm, 0.5 * (s + d), 0.5 * (s - d)


def eig_beam_chain(cppl, cpml, r1, r2, mu0, mu, w):
    """B4: the CUDA kernel on CUDA tensors (float32 only, 3 sweeps), the
    plain torch version on CPU tensors.  Shapes as in the module doc."""
    if cppl.device.type == "cpu":
        return eig_beam_chain_plain(cppl, cpml, r1, r2, mu0, mu, w)
    from sbdart_tpu_torch.kernels import _build

    nlyr, n, _, b = cppl.shape
    if n not in (4, 6, 8):
        raise ValueError(f"eig_beam_chain: the kernel takes N = 4, 6 or 8, "
                         f"got {n}")
    want = {"cppl": (nlyr, n, n, b), "cpml": (nlyr, n, n, b),
            "r1": (nlyr, n, b), "r2": (nlyr, n, b)}
    for name, t in zip(want, (cppl, cpml, r1, r2)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"eig_beam_chain: {name} has shape "
                             f"{tuple(t.shape)}, expected {want[name]}")
    if mu0.numel() != b:
        raise ValueError("eig_beam_chain: mu0 must be [1, B]")
    ins = [t.contiguous() for t in (cppl, cpml, r1, r2, mu0)]
    _build.require_cuda_f32("eig_beam_chain", *ins)
    consts = _kernel_consts(tuple(float(x) for x in mu),
                            tuple(float(x) for x in w))
    new = dict(device=cppl.device, dtype=torch.float32)
    kk = torch.empty((nlyr, n, b), **new)
    gp = torch.empty((nlyr, n, n, b), **new)
    gm = torch.empty((nlyr, n, n, b), **new)
    zp = torch.empty((nlyr, n, b), **new)
    zm = torch.empty((nlyr, n, b), **new)
    outs = (kk, gp, gm, zp, zm)
    lib = _build.library()
    with torch.cuda.device(cppl.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.sbdart_eig_beam(
            *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
            nlyr, n, b, consts.ctypes.data, stream,
        )
    eig_beam_chain.launches += 1
    _build.check(code, "eig_beam_chain")
    return outs


def eig_beam_chain_lane(cppl, cpml, r1, r2, mu0, tab, *, kernels=True,
                        sweeps=SWEEPS_F32):
    """The eigen chain + beam solve on a flat lane axis, as
    pallas/eig.py:eig_beam_chain_lane_fused: cppl/cpml [N, N, B], r1/r2
    [N, B], mu0 [1, B] (one beam cosine per lane) -> kk [N, B], gp/gm
    [N, N, B], zp/zm [N, B].  It runs the layered kernels on a one-layer
    view, as the reference does: B8 (kernels/eig_n2.py) at N = 2, B4 at
    N >= 4; the kernel wrappers when `kernels`, else the plain versions
    (B4's with `sweeps` Jacobi sweeps).  `tab` is the AngularTables."""
    ops = (cppl[None], cpml[None], r1[None], r2[None], mu0.reshape(1, -1))
    if cppl.shape[0] == 2:
        front = eig_beam_chain_n2 if kernels else eig_beam_chain_n2_plain
        out = front(*ops, tab)
    elif kernels:
        out = eig_beam_chain(*ops, tab.mu, tab.w)
    else:
        out = eig_beam_chain_plain(*ops, tab.mu, tab.w, sweeps=sweeps)
    return tuple(x[0] for x in out)


eig_beam_chain.launches = 0
