"""The flux lane's thermal front end at nstr = 4 before B3: delta-M
(solver/deltam.py:apply_deltam) and the beam's attenuation down the
column at the scaled and the unscaled optical depths, in scan layout, and
its CUDA kernel, csrc/deltam_attenuation.cu.

    tau_0 = 0,  tau_{l+1} = tau_l + dtau_l
    eb_l  = exp(-tau_l / mu0) where the lane has a beam, else 0

over the L + 1 levels, for dtau* (eb) and the unscaled dtau (eb_u).

The kernel replaces no TPU kernel: XLA fuses this glue in the JAX package
(solver/fluxlane.py:front_end), where torch runs it as ~30 kernels a call,
two of them innermost-dim cumsums.  `deltam_attenuation` launches the
kernel on CUDA tensors (float32 only) and runs `deltam_attenuation_plain`,
its plain twin, otherwise.  The twin runs apply_deltam unchanged and
writes each scan as an explicit loop of adds from a zero level, left to
right (ATen's cumsum fixes no order: a tree on the card, a float64
carry on the CPU); the kernel follows both op by op, so the two agree to
the bit on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from sbdart_tpu_torch import tracing
from sbdart_tpu_torch.kernels import use_kernel
from sbdart_tpu_torch.kernels.planck import _layout
from sbdart_tpu_torch.solver.deltam import F_MAX, apply_deltam, ssalb_dither

NSTR = 4       # the one order the kernel is built for: B3's
MAX_DIM = 6    # csrc/deltam_attenuation.cu:kMaxDim


def _batch(dtau, ssalb, pmom, mu0, has_beam):
    """The batch shape the five inputs broadcast to, and L."""
    nlyr = dtau.shape[-1]
    return tuple(torch.broadcast_shapes(
        dtau.shape[:-1], ssalb.shape[:-1], pmom.shape[:-2], mu0.shape,
        has_beam.shape)), nlyr


def deltam_attenuation_plain(dtau, ssalb, pmom, mu0, has_beam, deltam=True):
    """Plain torch version of the kernel, any device and float dtype:
    dtau, ssalb [..., L] and pmom [..., L, nmom] batch-major optics, mu0
    and has_beam [...] the beam cosine and mask (fluxlane.beam_rows).
    Returns (dtau* [L, B], ssalb* [L, B], g_l* [L, 4, B], eb [L+1, B],
    eb_u [L+1, B]), B the batch flattened row-major."""
    from sbdart_tpu_torch.solver.fluxlane import to_scan

    batch, nlyr = _batch(dtau, ssalb, pmom, mu0, has_beam)
    dtau = dtau.expand(batch + (nlyr,))
    dm = apply_deltam(dtau, ssalb.expand(batch + (nlyr,)),
                      pmom.expand(batch + pmom.shape[-2:]), NSTR, deltam)
    dts = to_scan(dm.dtau)
    mu0_row = mu0.expand(batch).reshape(1, -1)
    beam_row = has_beam.expand(batch).reshape(1, -1)

    def attenuation(d):
        tau = [torch.zeros_like(mu0_row[0])]
        for row in d:
            tau.append(tau[-1] + row)
        return torch.where(beam_row, torch.exp(-torch.stack(tau) / mu0_row),
                           0.0)

    return (dts, to_scan(dm.ssalb), to_scan(dm.gl, 2), attenuation(dts),
            attenuation(to_scan(dtau)))


def _index(batch, views):
    """csrc/deltam_attenuation.cu:DeltaMIndex as its launcher reads it:
    (ndim, [ndim batch sizes, each view's ndim batch strides, the layer
    strides of dtau, ssalb and pmom, pmom's moment stride]), the batch
    dims merged by planck._layout; `views` are (dtau, ssalb, pmom, mu0,
    has_beam) expanded to the batch."""
    dims = _layout(batch, views)
    if len(dims) > MAX_DIM:
        raise ValueError(f"deltam_attenuation: the batch {batch} walks "
                         f"{len(dims)} dims through its inputs' strides; "
                         f"the kernel takes at most {MAX_DIM}")
    sizes = [s for s, _ in dims]
    strides = [[st[a] for _, st in dims] for a in range(len(views))]
    layer = [v.stride(len(batch)) for v in views[:3]]
    return len(dims), np.asarray(sizes + sum(strides, []) + layer
                                 + [views[2].stride(-1)], np.int64)


def deltam_attenuation(dtau, ssalb, pmom, mu0, has_beam, deltam=True):
    """Delta-M and both beam attenuations in scan layout, arguments and
    result as deltam_attenuation_plain's.  CPU tensors: the plain version;
    CUDA tensors: the kernel (float32, has_beam bool), one launch, reading
    the inputs through their strides (broadcast batch dims at stride 0),
    every output contiguous."""
    if not use_kernel(dtau):
        return deltam_attenuation_plain(dtau, ssalb, pmom, mu0, has_beam,
                                        deltam)
    from sbdart_tpu_torch.kernels import _build

    _build.require_cuda_f32("deltam_attenuation", dtau, ssalb, pmom, mu0)
    if has_beam.dtype != torch.bool or has_beam.device != dtau.device:
        raise ValueError("deltam_attenuation: has_beam must be a bool tensor "
                         "on the inputs' device")
    if dtau.dim() < 1 or pmom.dim() < 2 or ssalb.dim() < 1:
        raise ValueError(f"deltam_attenuation: dtau, ssalb must be [..., L] "
                         f"and pmom [..., L, nmom], got {tuple(dtau.shape)}, "
                         f"{tuple(ssalb.shape)}, {tuple(pmom.shape)}")
    nlyr, nmom = dtau.shape[-1], pmom.shape[-1]
    if ssalb.shape[-1] != nlyr or pmom.shape[-2] != nlyr or nmom < 1:
        raise ValueError(f"deltam_attenuation: ssalb {tuple(ssalb.shape)} "
                         f"and pmom {tuple(pmom.shape)} must have dtau's "
                         f"{nlyr} layers and pmom a moment")
    batch, _ = _batch(dtau, ssalb, pmom, mu0, has_beam)
    nb = int(np.prod(batch, dtype=np.int64))
    new = dict(device=dtau.device, dtype=torch.float32)
    dts, ss = torch.empty((2, nlyr, nb), **new)
    gl = torch.empty((nlyr, NSTR, nb), **new)
    eb, eb_u = torch.empty((2, nlyr + 1, nb), **new)
    outs = (dts, ss, gl, eb, eb_u)
    if nb == 0:
        return outs
    views = (dtau.expand(batch + (nlyr,)), ssalb.expand(batch + (nlyr,)),
             pmom.expand(batch + (nlyr, nmom)), mu0.expand(batch),
             has_beam.expand(batch))
    ndim, dims_host = _index(batch, views)
    use_dm = bool(deltam) and nmom > NSTR
    # the clamps' bounds as ATen rounds a Python number: to float32
    ss_hi = float(np.float32(1.0 - ssalb_dither(torch.float32)))
    f_hi = float(np.float32(F_MAX))
    lib = _build.library()
    with torch.cuda.device(dtau.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.sbdart_deltam_attenuation(
            *(v.data_ptr() for v in views), *(o.data_ptr() for o in outs),
            nlyr, nmom, nb, int(use_dm), ss_hi, f_hi, ndim,
            dims_host.ctypes.data, stream,
        )
    tracing.count("kernels.deltam_attenuation.launches")
    _build.check(code, "deltam_attenuation")
    return outs
