"""B9: the eigen chain (SOLEIG) without the beam solve, N = 2, 4, 6, 8;
and the chain's plain torch steps, which B4 (kernels/eig_beam.py) shares.

Port of sbdart_tpu/pallas/eig.py:_kernel (reached via
eig_chain_lane_fused, which only the generic path's
solver/eig.py:solve_eigen calls, method "pallas").  Per (layer, column):
alpha -+ beta from C^pp/C^pm, the sqrt(mu w) congruence and
symmetrization, the trace ridge, Cholesky of S-, L^T S+ L, then the
eigensolve -- parallel-ordered cyclic Jacobi at N >= 4 (a fixed sweep
count, round-robin pair schedule) or the closed-form half-angle 2x2 eigh
at N = 2 (kernels/eig_n2.py:eigh2_half_angle, pallas/eig.py:258-261), no
eigenvalue sort either way -- and the triangular solve to G+-.

`eig_chain` launches a CUDA kernel where kernels/__init__.py:use_kernel
says so (`chain_entry`: at N = 2 the one-thread chain of
csrc/eig_chain.cu, at N = 4, 6, 8 B4's lane group kernel without the
beam solve, csrc/eig_beam_group.cu) and runs `eig_chain_plain`
otherwise.  Layout is layer-leading and column-minor: cppl/cpml
[L, N, N, B] -> kk [L, N, B], gp/gm [L, N, N, B].
`eig_chain_lane` is the counterpart of eig_chain_lane_fused: flat
[N, N, B] operands as a one-layer view.

The plain version takes every sum over a matrix index in order (k = 0,
1, ...) and divides by a tensor or multiplies by a reciprocal constant,
never divides by a Python number; the kernel does the same, term by term,
so the two agree to rounding on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sbdart_tpu_torch import tracing
from sbdart_tpu_torch.kernels import use_kernel
from sbdart_tpu_torch.kernels.eig_n2 import eigh2_half_angle
from sbdart_tpu_torch.ops.graph import const, index
from sbdart_tpu_torch.ops.lane import (
    _round_robin_pairs,
    lcholesky,
    lsolve_upper_tri,
)
from sbdart_tpu_torch.ops.lane import lmatmul as _mm

# Jacobi sweeps of the float32 kernels (kSweeps in csrc/eig_chain.cuh), the
# reference's DEFAULT_SWEEPS (pallas/eig.py:378-392, measured converged at
# 3).  The float64 route runs the reference lane route's 6 (ops/lane.py:260).
SWEEPS_F32 = 3
SWEEPS_F64 = 6


def sweeps_for(dtype: torch.dtype) -> int:
    """The plain chain's sweeps where a wrapper runs it: the kernel's in
    float32, the float64 route's otherwise."""
    return SWEEPS_F32 if dtype == torch.float32 else SWEEPS_F64


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
    """The kernels' EigChainConsts struct (csrc/eig_chain.cuh) as 36
    32-bit words: inv_mu, w, p, inv_p [8 each], ridge, eps, kk_floor, pad.
    (The lane-group chain takes its Jacobi pair schedule from
    csrc/eig_group.cuh:partner, the same round-robin as _jacobi_tables.)"""
    c = _consts(mu, w, torch.float32)
    n = c["n"]
    f = np.zeros(36, np.float32)
    for k, name in enumerate(("inv_mu", "w", "p", "inv_p")):
        f[8 * k:8 * k + n] = c[name]
    f[32:35] = (c["ridge"], c["eps"], c["kk_floor"])
    f.flags.writeable = False
    return f


def _vec(vals, like) -> torch.Tensor:
    """Constants as a [1, n, 1, 1] tensor for scaling rows (dim 1)."""
    return const(vals, like.dtype, like.device).reshape(1, -1, 1, 1)


def _sym(a):
    return 0.5 * (a + a.transpose(1, 2))


def _chol(a):
    """Lower Cholesky of SPD [L, n, n, B] (pallas/eig.py:_chol_inline):
    ops/lane.py:lcholesky on a view with the layers beside the lanes."""
    return lcholesky(a.permute(1, 2, 0, 3)).permute(2, 0, 1, 3)


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
    rounds = [(index(pt, a.device), _vec(-sg, a)[..., 0],
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


def _eigh2(a):
    """The half-angle 2x2 eigh on [L, 2, 2, B] (the chain at N = 2):
    (w [L, 2, B], v [L, 2, 2, B]), unsorted beyond its `wa <= wb` select."""
    k1, k2, v11, v12, v21, v22 = eigh2_half_angle(a[:, 0, 0], a[:, 0, 1],
                                                  a[:, 1, 1])
    v = torch.stack([torch.stack([v11, v12], dim=1),
                     torch.stack([v21, v22], dim=1)], dim=1)
    return torch.stack([k1, k2], dim=1), v


def _solve_ut(u, b):
    """U x = b, U upper-triangular [L, n, n, B], b [L, n, m, B]
    (ops/lane.py:lsolve_upper_tri on the same view as `_chol`)."""
    return lsolve_upper_tri(u.permute(1, 2, 0, 3),
                            b.permute(1, 2, 0, 3)).permute(2, 0, 1, 3)


def alpha_beta(c, cppl, cpml):
    """(alpha - beta, alpha + beta) = M^-1 (I - (C^pp +- C^pm) W) on
    [L, N, N, B], and the identity [1, N, N, 1]."""
    n = c["n"]
    eye = torch.eye(n, dtype=cppl.dtype, device=cppl.device)[None, :, :, None]
    inv_mu = _vec(c["inv_mu"], cppl)
    w_col = _vec(c["w"], cppl).transpose(1, 2)              # [1, 1, n, 1]
    amb = inv_mu * (eye - w_col * (cppl + cpml))
    apb = inv_mu * (eye - w_col * (cppl - cpml))
    return amb, apb, eye


def chain(c, amb, apb, eye, sweeps):
    """The chain after alpha -+ beta: (kk [L, N, B], gp, gm [L, N, N, B])."""
    n = c["n"]
    p_row = _vec(c["p"], amb)
    inv_p_col = _vec(c["inv_p"], amb).transpose(1, 2)
    s_minus = _sym(inv_p_col * (p_row * amb))
    s_plus = _sym(inv_p_col * (p_row * apb))
    trace = s_minus[:, 0, 0]
    for i in range(1, n):
        trace = trace + s_minus[:, i, i]
    s_minus = s_minus + (c["ridge"] * trace)[:, None, None, :] * eye
    l = _chol(s_minus)
    lt = l.transpose(1, 2)
    a = _sym(_mm(_mm(lt, s_plus), l))
    k2, v = _eigh2(a) if n == 2 else _jacobi(c, a, sweeps)
    kk = torch.sqrt(torch.clamp_min(k2, c["kk_floor"]))

    x = _vec(c["inv_p"], amb) * _solve_ut(lt, v)
    y = -_mm(amb, x) / kk[:, None, :, :]
    return kk, 0.5 * (x + y), 0.5 * (x - y)


def eig_chain_plain(cppl, cpml, mu, w, sweeps=SWEEPS_F32):
    """Plain torch version of the B9 kernel, any device and float dtype:
    cppl/cpml [L, N, N, B] -> (kk [L, N, B], gp, gm [L, N, N, B]);
    `sweeps` Jacobi sweeps at N >= 4 (the kernel's 3 by default)."""
    c = _consts(mu, w, cppl.dtype)
    return chain(c, *alpha_beta(c, cppl, cpml), sweeps)


def chain_entry(n: int) -> str:
    """The C entry that runs B9 at N = n: the one-thread half-angle chain
    at N = 2, the lane group chain (B4's kernel without the beam solve)
    at N = 4, 6, 8; a ValueError at any other N."""
    if n == 2:
        return "sbdart_eig_chain"
    if n in (4, 6, 8):
        return "sbdart_eig_chain_group"
    raise ValueError(f"eig_chain: the kernel takes N = 2, 4, 6 or 8, got {n}")


def eig_chain(cppl, cpml, mu, w):
    """B9: a CUDA kernel (float32 only, 3 sweeps; `chain_entry` names it
    by N) where use_kernel, else the plain torch version with `sweeps_for`
    its dtype.  Shapes as in the module doc."""
    if not use_kernel(cppl):
        return eig_chain_plain(cppl, cpml, mu, w,
                               sweeps=sweeps_for(cppl.dtype))
    from sbdart_tpu_torch.kernels import _build

    nlyr, n, _, b = cppl.shape
    entry = chain_entry(n)
    if nlyr > 65535:
        raise ValueError(f"eig_chain: the kernel takes at most 65535 layers "
                         f"a launch, got {nlyr}")
    for name, t in (("cppl", cppl), ("cpml", cpml)):
        if tuple(t.shape) != (nlyr, n, n, b):
            raise ValueError(f"eig_chain: {name} has shape "
                             f"{tuple(t.shape)}, expected {(nlyr, n, n, b)}")
    ins = [t.contiguous() for t in (cppl, cpml)]
    _build.require_cuda_f32("eig_chain", *ins)
    consts = _kernel_consts(tuple(float(x) for x in mu),
                            tuple(float(x) for x in w))
    new = dict(device=cppl.device, dtype=torch.float32)
    outs = (torch.empty((nlyr, n, b), **new),
            torch.empty((nlyr, n, n, b), **new),
            torch.empty((nlyr, n, n, b), **new))
    lib = _build.library()
    with torch.cuda.device(cppl.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, entry)(
            *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
            nlyr, n, b, consts.ctypes.data, stream,
        )
    tracing.count("kernels.eig_chain.launches")
    _build.check(code, "eig_chain")
    return outs


def eig_chain_lane(cppl, cpml, mu, w):
    """The chain on a flat lane axis, as pallas/eig.py:eig_chain_lane_fused:
    cppl/cpml [N, N, B] -> kk [N, B], gp/gm [N, N, B], through B9's
    wrapper on a one-layer view."""
    return tuple(x[0] for x in eig_chain(cppl[None], cpml[None], mu, w))
