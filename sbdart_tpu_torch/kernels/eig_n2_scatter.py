"""B3: the nstr=4 front end on delta-M-scaled optics (scattering build +
beam RHS + closed-form n = 2 eigen chain + beam solve).

Port of sbdart_tpu/pallas/eig.py:_n2_scatter_kernel (reached via
eig_beam_scatter_n2_layered), which the nstr=4 thermal path runs: it is
B1 without delta-M and without the dtau*/ee outputs, since the thermal
particular solution needs the scaled optics batch-major anyway.
`eig_beam_scatter_n2` launches the CUDA kernel csrc/eig_n2_scatter.cu on
CUDA tensors and runs `eig_beam_scatter_n2_plain` on CPU tensors.  Both
share B1's math: the plain side calls kernels/eig_n2.py:_scatter_chain,
the CUDA side includes csrc/eig_n2_chain.cuh.

Layout is column-minor: ssalb [L, B], gl [L, 4, B], scale/mu0 [1, B];
outputs kk [L, 2, B], gp/gm [L, 2, 2, B], zp/zm [L, 2, B], eigenpairs in
the chain's own `wa <= wb` order (no sort).
"""

from __future__ import annotations

import numpy as np
import torch

from sbdart_tpu_torch import tracing
from sbdart_tpu_torch.kernels import use_kernel
from sbdart_tpu_torch.kernels.eig_n2 import (
    _consts,
    _kernel_consts,
    _scatter_chain,
)


def eig_beam_scatter_n2_plain(ssalb, gl, scale, mu0, tab):
    """Plain torch version of the B3 kernel, any device and float dtype."""
    b = ssalb.shape[1]
    return _scatter_chain(_consts(tab, ssalb.dtype), ssalb,
                          [gl[:, q] for q in range(4)], scale.reshape(1, b),
                          mu0.reshape(1, b))


def eig_beam_scatter_n2(ssalb, gl, scale, mu0, tab):
    """B3 front end: the CUDA kernel on CUDA tensors (float32 only), the
    plain torch version on CPU tensors.  Shapes as in the module doc."""
    if not use_kernel(ssalb):
        return eig_beam_scatter_n2_plain(ssalb, gl, scale, mu0, tab)
    from sbdart_tpu_torch.kernels import _build

    nlyr, b = ssalb.shape
    if gl.shape != (nlyr, 4, b):
        raise ValueError(f"eig_beam_scatter_n2: shapes ssalb "
                         f"{tuple(ssalb.shape)}, gl {tuple(gl.shape)}")
    if scale.numel() != b or mu0.numel() != b:
        raise ValueError("eig_beam_scatter_n2: scale/mu0 must be [1, B]")
    ins = [x.contiguous() for x in (ssalb, gl, scale, mu0)]
    _build.require_cuda_f32("eig_beam_scatter_n2", *ins)
    consts = _kernel_consts(
        tuple(tab.mu), tuple(tab.w), tuple(np.ravel(tab.ylm[0])),
        tuple(tab.parity[0]),
    )
    new = dict(device=ssalb.device, dtype=torch.float32)
    kk = torch.empty((nlyr, 2, b), **new)
    gp = torch.empty((nlyr, 2, 2, b), **new)
    gm = torch.empty((nlyr, 2, 2, b), **new)
    zp = torch.empty((nlyr, 2, b), **new)
    zm = torch.empty((nlyr, 2, b), **new)
    outs = (kk, gp, gm, zp, zm)
    lib = _build.library()
    with torch.cuda.device(ssalb.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.sbdart_eig_n2_scatter(
            *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
            nlyr, b, consts.ctypes.data, stream,
        )
    tracing.count("kernels.eig_beam_scatter_n2.launches")
    _build.check(code, "eig_beam_scatter_n2")
    return outs
