"""B4: the general-n eigen chain + beam solve (nstr 8/12/16, N = 4, 6, 8).

Port of sbdart_tpu/pallas/eig.py:_kernel_beam (reached via
eig_beam_chain_lane_fused_layered).  Per (layer, column): the eigen chain
of B9 (kernels/eig_chain.py: alpha -+ beta, the congruence, ridged
Cholesky, parallel-ordered cyclic Jacobi without a sort, G+-), then the
reduced beam system

    [(a+b)(a-b) - I/mu0^2] S = (a+b) r1 - r2/mu0
    D = (r1 - (a-b) S) mu0 ;  Z+- = (S +- D)/2

solved by shrinking implicit-pivot elimination (kernels/blocktri_rt.py:
solve_step).  `eig_beam_chain` launches the CUDA kernel
csrc/eig_beam_group.cu (a group of lanes per (layer, column), lane i on
row i; the chain in csrc/eig_group.cuh) where kernels/__init__.py:use_kernel
says so and runs `eig_beam_chain_plain` otherwise.

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

import torch

from sbdart_tpu_torch import tracing
from sbdart_tpu_torch.kernels import use_kernel
from sbdart_tpu_torch.kernels.blocktri_rt import solve_step
from sbdart_tpu_torch.kernels.eig_chain import (
    SWEEPS_F32,
    _consts,
    _kernel_consts,
    alpha_beta,
    chain,
    sweeps_for,
)
from sbdart_tpu_torch.kernels.eig_n2 import eig_beam_chain_n2
from sbdart_tpu_torch.ops.lane import lmatmul as _mm
from sbdart_tpu_torch.ops.lane import lmatvec as _mv


def eig_beam_chain_plain(cppl, cpml, r1, r2, mu0, mu, w, sweeps=SWEEPS_F32):
    """Plain torch version of the B4 kernel, any device and float dtype.
    Shapes as in the module doc; `sweeps` Jacobi sweeps (the kernel's 3
    by default)."""
    c = _consts(mu, w, cppl.dtype)
    amb, apb, eye = alpha_beta(c, cppl, cpml)
    kk, gp, gm = chain(c, amb, apb, eye, sweeps)

    mu0 = mu0.reshape(1, -1)
    inv_mu0 = 1.0 / mu0
    mat = _mm(apb, amb) - eye * (inv_mu0 * inv_mu0)[:, None, None, :]
    rhs = _mv(apb, r1) - r2 * inv_mu0[:, None, :]
    s = solve_step(mat, rhs[:, :, None, :])[:, :, 0]
    d = (r1 - _mv(amb, s)) * mu0[:, None, :]
    return kk, gp, gm, 0.5 * (s + d), 0.5 * (s - d)


def eig_beam_chain(cppl, cpml, r1, r2, mu0, mu, w):
    """B4: the CUDA kernel (float32 only, 3 sweeps) where use_kernel,
    else the plain torch version with `sweeps_for` its dtype.  Shapes as
    in the module doc."""
    if not use_kernel(cppl):
        return eig_beam_chain_plain(cppl, cpml, r1, r2, mu0, mu, w,
                                    sweeps=sweeps_for(cppl.dtype))
    from sbdart_tpu_torch.kernels import _build

    nlyr, n, _, b = cppl.shape
    if n not in (4, 6, 8):
        raise ValueError(f"eig_beam_chain: the kernel takes N = 4, 6 or 8, "
                         f"got {n}")
    if nlyr > 65535:
        raise ValueError(f"eig_beam_chain: the kernel takes at most 65535 "
                         f"layers a launch, got {nlyr}")
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
        code = lib.sbdart_eig_beam_group(
            *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
            nlyr, n, b, consts.ctypes.data, stream,
        )
    tracing.count("kernels.eig_beam_chain.launches")
    _build.check(code, "eig_beam_chain")
    return outs


def eig_beam_chain_lane(cppl, cpml, r1, r2, mu0, tab):
    """The eigen chain + beam solve on a flat lane axis, as
    pallas/eig.py:eig_beam_chain_lane_fused: cppl/cpml [N, N, B], r1/r2
    [N, B], mu0 [1, B] (one beam cosine per lane) -> kk [N, B], gp/gm
    [N, N, B], zp/zm [N, B].  It runs the layered kernels' wrappers on a
    one-layer view, as the reference does: B8 (kernels/eig_n2.py) at
    N = 2, B4 at N >= 4.  `tab` is the AngularTables."""
    ops = (cppl[None], cpml[None], r1[None], r2[None], mu0.reshape(1, -1))
    if cppl.shape[0] == 2:
        out = eig_beam_chain_n2(*ops, tab)
    else:
        out = eig_beam_chain(*ops, tab.mu, tab.w)
    return tuple(x[0] for x in out)
