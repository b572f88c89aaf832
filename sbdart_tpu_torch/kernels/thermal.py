"""The flux lane's thermal particular solution, azimuth mode 0, in the
BVP's scan layout, and its CUDA kernel, csrc/thermal_particular.cu.

From the delta-M-scaled optics of each lane (batch element x layer) and
the Planck radiance at the layer's two levels:

    c_l   = 0.5 w0 (2l+1) g_l
    C^pp  = sum_l c_l Lam_l(mu_i) Lam_l(mu_j),  C^pm likewise with (-1)^l
    Y1+ = Y1- = S1/2,     (alpha-beta) S1 = 2 (1-w0) b1 / mu
    Y0+- = (S0 +- D0)/2,  (alpha-beta) S0 = 2 (1-w0) Btop / mu
                          (alpha+beta) D0 = S1

(solver/sources.py:thermal_particular; disort.f:UPISOT), written straight
into [L, N, B], B the batch flattened row-major.

The kernel replaces no TPU kernel: XLA fuses this glue in the JAX package
(solver/fluxlane.py:_thermal), where torch runs it as ~128 kernels a call
on [..., L, N, N+2] stacks.  `thermal_particular_scan` launches the kernel
on CUDA tensors (float32 only) and runs `thermal_particular_scan_plain`,
its plain twin, on CPU tensors.  The twin writes the einsums that build
C^pp/C^pm as explicit sums over l, left to right, in the factor order of
the einsum strings (a GEMM fixes no summation order), and solves with
sources.thermal_particular unchanged; the kernel follows both op by op,
so the two agree to the bit on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from sbdart_tpu_torch import tracing
from sbdart_tpu_torch.constants import slope_tau_floor
from sbdart_tpu_torch.kernels import use_kernel
from sbdart_tpu_torch.kernels.planck import _layout
from sbdart_tpu_torch.ops.graph import const
from sbdart_tpu_torch.solver.sources import thermal_particular

ORDERS = (2, 4, 6, 8)  # N the kernel is built for: the flux lane's domain
MAX_DIM = 6            # csrc/thermal_particular.cu:kMaxDim
_MAX_N = 8
_MAX_NSTR = 16


def mode0_matrices(ssalb, gl, tab):
    """C^pp, C^pm of mode 0 [..., L, N, N] from ssalb [..., L] and gl
    [..., L, nstr]: the einsums "...Ll,li,lj->...Lij" and
    "...Ll,l,li,lj->...Lij" as explicit sums over l, term l rounded as
    ((c_l [par_l]) ylm_li) ylm_lj and added left to right."""
    dtype, device = gl.dtype, gl.device

    def t(x):
        return const(x, dtype, device)

    ylm = t(tab.ylm[0])                                  # [nstr, N]
    c = 0.5 * ssalb[..., None] * t(tab.twol1) * gl       # [..., L, nstr]
    cp = c * t(tab.parity[0])
    cpp = cpm = None
    for l in range(gl.shape[-1]):
        yi, yj = ylm[l][:, None], ylm[l][None, :]
        tpp = c[..., l, None, None] * yi * yj
        tpm = cp[..., l, None, None] * yi * yj
        cpp = tpp if cpp is None else cpp + tpp
        cpm = tpm if cpm is None else cpm + tpm
    return cpp, cpm


def thermal_particular_scan_plain(ssalb, dtau, gl, b_level, tab):
    """Plain torch version of the kernel, any device and float dtype:
    ssalb, dtau [..., L] and gl [..., L, nstr] delta-M scaled, b_level
    [..., L+1] Planck at the levels, tab the AngularTables.  Returns
    (Y0+, Y0-, Y1+, Y1-), each [L, N, B]; Y1- is Y1+."""
    from sbdart_tpu_torch.solver.fluxlane import to_scan

    cpp, cpm = mode0_matrices(ssalb, gl, tab)
    th = thermal_particular(cpp, cpm, ssalb, dtau, b_level, tab)
    y1 = to_scan(th.y1p, 2)
    return to_scan(th.y0p, 2), to_scan(th.y0m, 2), y1, y1


def _kernel_consts(tab) -> np.ndarray:
    """csrc/thermal_particular.cu:ThermalConsts from the tables, each as
    the plain version's device constants hold it (the table in float32;
    1/mu as ATen's reciprocal rounds it, an IEEE division), padded to the
    largest order."""
    f32 = np.float32
    nstr = len(tab.twol1)
    ylm = np.zeros((_MAX_NSTR, _MAX_N), f32)
    ylm[:nstr, :nstr // 2] = np.asarray(tab.ylm[0], f32)

    def pad(x, size):
        out = np.zeros(size, f32)
        out[:len(x)] = x
        return out

    return np.concatenate([
        pad(np.asarray(tab.twol1, f32), _MAX_NSTR), ylm.ravel(),
        pad(np.asarray(tab.parity[0], f32), _MAX_NSTR),
        pad(f32(1.0) / np.asarray(tab.mu, f32), _MAX_N),
        pad(np.asarray(tab.w, f32), _MAX_N),
        np.asarray([slope_tau_floor(torch.float32)], f32),
    ])


def _shapes(ssalb, dtau, gl, b_level, tab):
    """(batch shape, L, N), or a ValueError naming what the kernel does
    not take."""
    nlyr, nstr = gl.shape[-2:] if gl.dim() >= 2 else (None, None)
    if nstr is None or nstr % 2 or nstr // 2 not in ORDERS:
        raise ValueError(f"thermal_particular_scan: gl must be [..., L, nstr]"
                         f" with nstr in {tuple(2 * n for n in ORDERS)}, got "
                         f"{tuple(gl.shape)}")
    if len(tab.twol1) != nstr:
        raise ValueError(f"thermal_particular_scan: tables of nstr="
                         f"{len(tab.twol1)} for gl of nstr={nstr}")
    for name, x, size in (("ssalb", ssalb, nlyr), ("dtau", dtau, nlyr),
                          ("b_level", b_level, nlyr + 1)):
        if x.dim() < 1 or x.shape[-1] != size:
            raise ValueError(f"thermal_particular_scan: {name} must end in "
                             f"{size}, got {tuple(x.shape)}")
    batch = torch.broadcast_shapes(ssalb.shape[:-1], dtau.shape[:-1],
                                   gl.shape[:-2], b_level.shape[:-1])
    return tuple(batch), nlyr, nstr // 2


def _index(batch, views):
    """csrc/thermal_particular.cu:ThermalIndex as its launcher reads it:
    (ndim, [ndim batch sizes, each view's ndim batch strides, the views'
    layer strides, gl's moment stride]), the batch dims merged by
    planck._layout; `views` are (ssalb, dtau, gl, b_level) expanded to
    the batch."""
    dims = _layout(batch, views)
    if len(dims) > MAX_DIM:
        raise ValueError(f"thermal_particular_scan: the batch {batch} walks "
                         f"{len(dims)} dims through its inputs' strides; "
                         f"the kernel takes at most {MAX_DIM}")
    sizes = [s for s, _ in dims]
    strides = [[st[a] for _, st in dims] for a in range(4)]
    layer = [v.stride(len(batch)) for v in views]
    return len(dims), np.asarray(sizes + sum(strides, []) + layer
                                 + [views[2].stride(-1)], np.int64)


def thermal_particular_scan(ssalb, dtau, gl, b_level, tab):
    """The thermal particular solution in scan layout, arguments and
    result as thermal_particular_scan_plain's.  CPU tensors: the plain
    version; CUDA tensors: the kernel (float32 only), one launch, reading
    the inputs through their strides (broadcast batch dims at stride 0)."""
    if not use_kernel(ssalb):
        return thermal_particular_scan_plain(ssalb, dtau, gl, b_level, tab)
    from sbdart_tpu_torch.kernels import _build

    _build.require_cuda_f32("thermal_particular_scan", ssalb, dtau, gl,
                            b_level)
    batch, nlyr, n = _shapes(ssalb, dtau, gl, b_level, tab)
    nb = int(np.prod(batch, dtype=np.int64))
    out = torch.empty((3, nlyr, n, nb), device=ssalb.device,
                      dtype=torch.float32)
    y0p, y0m, y1 = out
    if out.numel() == 0:
        return y0p, y0m, y1, y1
    views = (ssalb.expand(batch + (nlyr,)), dtau.expand(batch + (nlyr,)),
             gl.expand(batch + (nlyr, 2 * n)),
             b_level.expand(batch + (nlyr + 1,)))
    ndim, dims_host = _index(batch, views)
    consts = _kernel_consts(tab)
    lib = _build.library()
    with torch.cuda.device(ssalb.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.sbdart_thermal_particular(
            *(v.data_ptr() for v in views), out.data_ptr(), n, nlyr, nb,
            ndim, dims_host.ctypes.data, consts.ctypes.data, stream,
        )
    tracing.count("kernels.thermal_particular_scan.launches")
    _build.check(code, "thermal_particular_scan")
    return y0p, y0m, y1, y1
