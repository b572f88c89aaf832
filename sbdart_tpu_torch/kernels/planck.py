"""The band-integrated Planck function (torch port of
sbdart_tpu/solver/planck.py:planck_band; disort.f:PLKAVG) and its CUDA
kernel, csrc/planck_band.cu.

    B(T; nu1, nu2) = integral_{nu1}^{nu2} B_nu(T) d nu    [W m^-2 sr^-1]

The reference's split: a power series of int_0^x t^3/(e^t - 1) dt for
small x = c2 nu / T and an exponential series of the complementary
integral for large x, both evaluated and `where`-selected, so the call is
branchless over (level, band) tensors.  Integer powers are written as the
products XLA's integer_pow forms (x^3 = x (x x), x^4 = (x x)(x x)), so
both packages round alike.

The kernel replaces no TPU kernel: XLA fuses this function in the JAX
package, where torch runs it as ~450 elementwise kernels a call.
`planck_band` launches the kernel on CUDA tensors (float32 only) and
runs `planck_band_plain`, its plain twin, on CPU tensors.  The kernel
reads its inputs through their strides (the solver's stride-0
expanded views in place) and rounds as ATen's CUDA kernels round the
plain version, so the two agree to the bit on the card.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from sbdart_tpu_torch.constants import C2_RADIATION, STEFAN_BOLTZMANN
from sbdart_tpu_torch.ops.graph import as_device

_PI4_15 = 15.0 / math.pi**4
# Series int_0^x t^3/(e^t-1) dt = x^3 * sum_k a_k x^k  (Bernoulli expansion)
_POW_COEF = (1.0 / 3.0, -1.0 / 8.0, 1.0 / 60.0, 0.0, -1.0 / 5040.0, 0.0,
             1.0 / 272160.0, 0.0, -1.0 / 13305600.0)
_XCUT = 1.0          # series switch point (both accurate to ~1e-9 there)
_NEXP_TERMS = 16     # exp-series terms; tail at x=1 ~ e^-17, negligible
_TMIN = 1e-6         # temperature clamp
MAX_DIM = 8          # csrc/planck_band.cu:kMaxDim


def _cum_fraction(x: torch.Tensor) -> torch.Tensor:
    """F(0->x) = (15/pi^4) * int_0^x t^3/(e^t-1) dt, in [0, 1]."""
    xs = torch.clamp_max(x, _XCUT)    # keep the power series in its domain
    p = torch.zeros_like(xs)
    for k in reversed(range(len(_POW_COEF))):
        p = p * xs + _POW_COEF[k]
    lo = _PI4_15 * (xs * (xs * xs)) * p
    xl = torch.clamp_min(x, _XCUT)
    xl2 = xl * xl
    xl3 = xl * xl2
    s = torch.zeros_like(xl)
    for n in range(1, _NEXP_TERMS + 1):
        s = s + torch.exp(-n * xl) * (
            xl3 / n + 3.0 * xl2 / n**2 + 6.0 * xl / n**3 + 6.0 / n**4
        )
    hi = 1.0 - _PI4_15 * s
    return torch.where(x <= _XCUT, lo, hi)


def _inputs(wvnlo, wvnhi, temp, dtype):
    """The three arguments as tensors of `dtype` on the device of the
    first tensor among them (temp first)."""
    dev = next((a.device for a in (temp, wvnlo, wvnhi)
                if isinstance(a, torch.Tensor)), None)
    return tuple(as_device(a, dtype, dev) for a in (wvnlo, wvnhi, temp))


def planck_band_plain(wvnlo, wvnhi, temp, dtype=torch.float64):
    """Plain torch version of the kernel, op by op, any device and float
    dtype; arguments as planck_band's."""
    wvnlo, wvnhi, t = _inputs(wvnlo, wvnhi, temp, dtype)
    t = torch.clamp_min(t, _TMIN)
    x1 = C2_RADIATION * wvnlo / t
    x2 = C2_RADIATION * wvnhi / t
    frac = _cum_fraction(x2) - _cum_fraction(x1)
    t2 = t * t
    return (STEFAN_BOLTZMANN / math.pi) * (t2 * t2) * frac


@functools.cache
def _kernel_consts() -> np.ndarray:
    """csrc/planck_band.cu:PlanckConsts, each scalar as ATen rounds it on
    the card: a Python number to float32, and a tensor divided by one a
    multiply by its float32 reciprocal, taken on the host."""
    n = np.arange(1, _NEXP_TERMS + 1)
    one = np.float32(1.0)
    vals = [C2_RADIATION, STEFAN_BOLTZMANN / math.pi, _PI4_15, _TMIN, _XCUT,
            3.0, 6.0, *_POW_COEF, *(-n)]
    return np.concatenate([
        np.asarray(vals, np.float32),
        one / n.astype(np.float32),
        one / (n**2).astype(np.float32),
        one / (n**3).astype(np.float32),
        np.asarray([6.0 / k**4 for k in range(1, _NEXP_TERMS + 1)],
                   np.float32),
    ])


def _layout(shape, views) -> list:
    """The output's dims with size-1 dims dropped and neighbours merged
    where every view steps through them as one: [(size, [stride of each
    view])], innermost last.  The output is contiguous, so its row-major
    order over these dims is its own."""
    dims = []
    for d, size in enumerate(shape):
        if size == 1:
            continue
        strides = [v.stride(d) for v in views]
        if dims and all(s0 == s * size for s0, s in zip(dims[-1][1], strides)):
            dims[-1] = (dims[-1][0] * size, strides)
        else:
            dims.append((size, strides))
    return dims


def planck_band(wvnlo, wvnhi, temp, dtype=torch.float64) -> torch.Tensor:
    """Planck radiance integrated over [wvnlo, wvnhi] cm^-1 at temp K, in
    `dtype` (float64 by default; the f32 flux path evaluates in float32,
    as the reference's does).  Tensor arguments broadcast together and set
    the device.  CPU tensors: planck_band_plain; CUDA tensors: the kernel
    (float32 only), one launch."""
    wvnlo, wvnhi, temp = _inputs(wvnlo, wvnhi, temp, dtype)
    if temp.device.type == "cpu":
        return planck_band_plain(wvnlo, wvnhi, temp, dtype)
    from sbdart_tpu_torch.kernels import _build

    _build.require_cuda_f32("planck_band", temp, wvnlo, wvnhi)

    shape = torch.broadcast_shapes(wvnlo.shape, wvnhi.shape, temp.shape)
    out = torch.empty(shape, device=temp.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    views = [v.expand(shape) for v in (wvnlo, wvnhi, temp)]
    dims = _layout(shape, views)
    if len(dims) > MAX_DIM:
        raise ValueError(f"planck_band: the broadcast {tuple(shape)} walks "
                         f"{len(dims)} dims through its inputs' strides; "
                         f"the kernel takes at most {MAX_DIM}")
    sizes = [s for s, _ in dims]
    strides = [[st[a] for _, st in dims] for a in range(3)]
    # one element more, so that ctypes gets a buffer at ndim 0 too
    dims_host = np.asarray(sizes + sum(strides, []) + [0], np.int64)
    consts = _kernel_consts()
    lib = _build.library()
    with torch.cuda.device(temp.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.sbdart_planck_band(
            *(v.data_ptr() for v in views), out.data_ptr(), out.numel(),
            len(dims), dims_host.ctypes.data, consts.ctypes.data, stream,
        )
    planck_band.launches += 1
    _build.check(code, "planck_band")
    return out


planck_band.launches = 0
