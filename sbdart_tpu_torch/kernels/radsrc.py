"""B7: the radiance source projections and per-layer path integrals
(USRINT), one thread per (azimuth mode, lane), lane = (layer, column).

Port of sbdart_tpu/pallas/radsrc.py:_kernel (reached via rad_source_lane
from solver/radlane.py).  For every mode m, lane (layer, column) and user
cosine u it computes

    j[m, u] = sum_j a_j sd(u, j) I_dn(u, k_j) + sum_j b_j su(u, j) I_up(u, k_j)
              + sz_tot(u) expbea_top I_beam(u)

with the eigenmode source amplitudes sd/su and the beam source sz_tot
projected to user angles through the static Legendre tables t1/t2/yu,
and the analytic per-layer path integrals (`_int_toward`, and
`_int_away` with its Taylor branch on the resonance |u k - 1| < 1e-5).
The sign of u picks which integral goes with which term.

`rad_source_lane` launches the CUDA kernel csrc/radsrc.cu on CUDA tensors
and runs `rad_source_lane_plain` on CPU tensors.  Operands, as the
reference's: t1/t2 [M, U, N, nstr], yu [M, U, nstr] (static tables), c
[nstr, LB], y0d [M, nstr, LB], gp/gm [M, N, N, LB], kk/zp/zm/a/b [M, N, LB],
dtau/ebtop/mu0/scale [1, LB]; umu [U] (host numbers, nonzero).  Returns
j [M, U, LB].  The kernel reads every per-lane operand in place through
its strides (the radiance path hands gp, gm, kk, zp and zm as views of
the eigen chain's flat output), so the wrapper takes any layout whose
lane axis has stride 1 and refuses the others, on either device.

Where the reference divides by a user cosine or its reciprocal (a Python
number), both versions here multiply by the other one, each taken once on
the host in the working precision (`_angle_consts`), so the kernel and
the plain version round alike.
"""

from __future__ import annotations

import numpy as np
import torch

from sbdart_tpu_torch.ops.graph import const

RES_EPS = 1e-5      # resonance half-width of the 'away' integral
MAX_ANGLES = 20     # SBDART's uzen limit; the kernel's table size


def _angle_consts(umu, dtype=torch.float32) -> np.ndarray:
    """[3, U]: upward (1.0 for u > 0, else 0.0), |u|, 1/|u|, rounded to
    float32 for a float32 solve."""
    u = np.asarray(umu, np.float64)
    if np.any(u == 0.0):
        raise ValueError("user view cosines must be nonzero")
    out = np.stack([(u > 0).astype(np.float64), np.abs(u), 1.0 / np.abs(u)])
    return out.astype(np.float32) if dtype == torch.float32 else out


def _int_toward(k, delta, inv_u, u):
    """Integral of the decay toward the path start (radsrc.py:45-47)."""
    return (1.0 - torch.exp(-(k + inv_u) * delta)) / (k * u + 1.0)


def _int_away(k, delta, u, inv_u):
    """Resonance-safe 'away' integral (radsrc.py:50-58)."""
    e_u = torch.exp(-delta * inv_u)
    d = u * k - 1.0
    near = torch.abs(d) < RES_EPS
    safe = torch.where(near, 1.0, d)
    exact = (e_u - torch.exp(-k * delta)) / safe
    taylor = e_u * (delta * inv_u) * (1.0 - d * delta * (0.5 * inv_u))
    return torch.where(near, taylor, exact)


def _dot(e, g):
    """sum_i e[i] * g[:, i], in order (g [M, N, LB], e a list of [M, LB])."""
    s = e[0] * g[:, 0]
    for i in range(1, len(e)):
        s = s + e[i] * g[:, i]
    return s


def rad_source_lane_plain(t1, t2, yu, c, y0d, gp, gm, kk, zp, zm, a, b,
                          dtau, ebtop, mu0, scale, umu):
    """Plain torch version of the B7 kernel, any device and float dtype;
    every sum runs in the kernel's order.  Shapes as in the module doc."""
    nm, nu, n, nstr = t1.shape
    up, ua, inv_ua = (row.tolist() for row in _angle_consts(umu, c.dtype))
    mfac = const(np.where(np.arange(nm) == 0, 1.0, 2.0)[:, None], c.dtype,
                 c.device)
    dtau, ebtop, mu0, scale = (x.reshape(1, -1)
                               for x in (dtau, ebtop, mu0, scale))
    amp = mfac * scale                                  # [M, LB]
    inv_mu0 = 1.0 / mu0
    rows = []
    for u in range(nu):
        e1, e2 = [], []
        for i in range(n):
            s1 = t1[:, u, i, 0, None] * c[0]
            s2 = t2[:, u, i, 0, None] * c[0]
            for l in range(1, nstr):
                s1 = s1 + t1[:, u, i, l, None] * c[l]
                s2 = s2 + t2[:, u, i, l, None] * c[l]
            e1.append(s1)
            e2.append(s2)
        sz = _dot(e1, zp) + _dot(e2, zm)
        x0u = yu[:, u, 0, None] * (c[0] * y0d[:, 0])
        for l in range(1, nstr):
            x0u = x0u + yu[:, u, l, None] * (c[l] * y0d[:, l])
        sz_tot = sz + x0u * amp
        if up[u] > 0.0:
            def i_dn(k):
                return _int_toward(k, dtau, inv_ua[u], ua[u])

            def i_up(k):
                return _int_away(k, dtau, ua[u], inv_ua[u])
            int_beam = _int_toward(inv_mu0, dtau, inv_ua[u], ua[u])
        else:
            def i_dn(k):
                return _int_away(k, dtau, ua[u], inv_ua[u])

            def i_up(k):
                return _int_toward(k, dtau, inv_ua[u], ua[u])
            int_beam = _int_away(inv_mu0, dtau, ua[u], inv_ua[u])
        for j in range(n):
            sd = _dot(e1, gp[:, :, j]) + _dot(e2, gm[:, :, j])
            su = _dot(e1, gm[:, :, j]) + _dot(e2, gp[:, :, j])
            t_dn = a[:, j] * sd * i_dn(kk[:, j])
            t_up = b[:, j] * su * i_up(kk[:, j])
            s_dn = t_dn if j == 0 else s_dn + t_dn
            s_up = t_up if j == 0 else s_up + t_up
        rows.append(s_dn + s_up + sz_tot * ebtop * int_beam)
    return torch.stack(rows, dim=1)                     # [M, U, LB]


LANE_OPERANDS = ("c", "y0d", "gp", "gm", "kk", "zp", "zm", "a", "b")


def _check_operands(t1, t2, yu, lanes, rows, umu):
    """The wrapper's shape and layout checks (on either device): the
    reference's shapes, and a lane axis of stride 1 on every per-lane
    operand, since the kernel reads them in place."""
    nm, nu, n, nstr = t1.shape
    lb = lanes[0].shape[-1]
    if len(umu) != nu:
        raise ValueError(f"rad_source_lane: {nu} angles in the tables, "
                         f"umu has {len(umu)}")
    want = {"t1": (nm, nu, n, nstr), "t2": (nm, nu, n, nstr),
            "yu": (nm, nu, nstr), "c": (nstr, lb), "y0d": (nm, nstr, lb),
            "gp": (nm, n, n, lb), "gm": (nm, n, n, lb), "kk": (nm, n, lb),
            "zp": (nm, n, lb), "zm": (nm, n, lb), "a": (nm, n, lb),
            "b": (nm, n, lb)}
    for name, x in zip(want, (t1, t2, yu) + lanes):
        if tuple(x.shape) != want[name]:
            raise ValueError(f"rad_source_lane: {name} has shape "
                             f"{tuple(x.shape)}, expected {want[name]}")
    if any(x.numel() != lb for x in rows):
        raise ValueError("rad_source_lane: dtau/ebtop/mu0/scale must be "
                         "[1, LB]")
    names = LANE_OPERANDS + ("dtau", "ebtop", "mu0", "scale")
    for name, x in zip(names, lanes + rows):
        if lb > 1 and x.stride(-1) != 1:
            raise ValueError(
                f"rad_source_lane: {name} has lane stride {x.stride(-1)}; "
                "the kernel reads every per-lane operand in place, lane "
                "stride 1 (make it contiguous first)")


def _strides(x):
    """(mode, row, column) strides of a lane operand, 0 where it has no
    such axis (c: [nstr, LB]; y0d, kk..b: [M, R, LB]; gp, gm: [M, N, N,
    LB])."""
    st = ((0,) if x.dim() == 2 else ()) + x.stride()[:-1]
    return st + (0,) * (3 - len(st))


def rad_source_lane(t1, t2, yu, c, y0d, gp, gm, kk, zp, zm, a, b,
                    dtau, ebtop, mu0, scale, umu):
    """B7: the CUDA kernel on CUDA tensors (float32 only), the plain torch
    version on CPU tensors.  Shapes as in the module doc.  Every per-lane
    operand is read in place (the radiance path's views of the eigen
    output among them), so each must have lane stride 1, else ValueError;
    the static tables are used as they are where contiguous and 16-byte
    aligned, else copied (a few KB)."""
    lanes = (c, y0d, gp, gm, kk, zp, zm, a, b)
    rows = (dtau, ebtop, mu0, scale)
    _check_operands(t1, t2, yu, lanes, rows, umu)
    if c.device.type == "cpu":
        return rad_source_lane_plain(t1, t2, yu, c, y0d, gp, gm, kk, zp, zm,
                                     a, b, dtau, ebtop, mu0, scale, umu)
    from sbdart_tpu_torch.kernels import _build

    nm, nu, n, nstr = t1.shape
    lb = c.shape[-1]
    if n not in (2, 4, 6, 8) or nstr != 2 * n:
        raise ValueError(f"rad_source_lane: the kernel takes N = 2, 4, 6 or "
                         f"8 and nstr = 2N, got N={n}, nstr={nstr}")
    if not 0 < nu <= MAX_ANGLES:
        raise ValueError(f"rad_source_lane: 1 to {MAX_ANGLES} user angles, "
                         f"got {nu}")
    tables = tuple(
        x if x.is_contiguous() and x.data_ptr() % 16 == 0
        else x.clone(memory_format=torch.contiguous_format)
        for x in (t1, t2, yu))
    _build.require_cuda_f32("rad_source_lane", *tables, *lanes, *rows)
    ptrs = np.array([x.data_ptr() for x in lanes], np.uint64)
    strides = np.array([_strides(x) for x in lanes], np.int64)
    angles = np.zeros((3, MAX_ANGLES), np.float32)
    angles[:, :nu] = _angle_consts(umu)
    j = torch.empty((nm, nu, lb), device=c.device, dtype=torch.float32)
    lib = _build.library()
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.sbdart_radsrc(
            *(x.data_ptr() for x in tables), ptrs.ctypes.data,
            strides.ctypes.data, *(x.data_ptr() for x in rows), j.data_ptr(),
            nm, nu, n, lb, angles.ctypes.data, stream,
        )
    rad_source_lane.launches += 1
    _build.check(code, "rad_source_lane")
    return j


rad_source_lane.launches = 0
