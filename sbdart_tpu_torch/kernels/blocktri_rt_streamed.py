"""B6: fused SETMTX + SOLVE0 for general n with the rank-N factor history,
as a forward kernel and a backward kernel, and the routing of every
boundary-value solve.

Port of sbdart_tpu/pallas/blocktri.py:_rt_fwd_chunk_kernel and
_rt_bwd_chunk_kernel, which its block_thomas_rt runs instead of _rt_kernel
(B5, kernels/blocktri_rt.py) when one 128-lane tile of the whole column
would not fit the TPU's VMEM: at N = 8 from 42 layers on, at N = 6 from 71,
at N = 4 from 147, at N = 2 from 473 (`reference_streams`).  At N = 2 the
reference first tries its planar kernel (B2, kernels/blocktri_n2.py), up
to 51 layers (`reference_route`); `solve_bvp` runs the kernel the
reference runs at each shape, and nothing else picks a BVP kernel.  The blocks are those of B5; the
factor kept per layer is C_l = dt_l^-1[:, N:] (2N x N) instead of W_l
(2N x 2N), since W_l = C_l ub_l with ub_l = -[gp_{l+1}, gm_{l+1} e_{l+1}]
the bottom rows of the upper block (blocktri.py:235-249):

    forward   dt_l = diag_l - [(lt_l C_{l-1}) ub_{l-1}; 0]
              dt_l [C_l | y_l] = [I_bottom | r_l - [lt_l y_{l-1}; 0]]
    backward  x_{L-1} = y_{L-1};  x_l = y_l - C_l (ub_l x_{l+1})

The two round differently from B5, so the flux path picks the one the
reference picks at each shape.  The TPU version chunks the layers to fit
VMEM and pads them with identity layers; neither changes a real layer's
value, and neither is kept.

`block_thomas_rt_fwd` and `block_thomas_rt_bwd` launch CUDA kernels on
CUDA tensors and run their plain versions on CPU tensors.  The forward
kernel has two designs, one thread per column
(csrc/blocktri_rt_streamed.cuh, templated on N) and a group of lanes per
column on the elimination core (csrc/blocktri_rt_streamed_group.cu, N a
run-time argument, up to the N whose system fills the card's shared
memory), picked by `FWD_ONE_THREAD_N`.  The backward kernel is a lane
group per column streaming the layers through a ring of shared-memory
slots (csrc/blocktri_rt_bwd.cu, `block_thomas_rt_bwd_group`), at every N
(`BWD_ONE_THREAD_N` is empty).  Inputs gp/gm [L, N, N, B],
ee [L, N, B], refl [N, N, B], rhs [L, 2N, B]; the history is cs
[L, 2N, N, B] and ys [L, 2N, B]; the solution xs [L, 2N, B].
"""

from __future__ import annotations

import torch

from sbdart_tpu_torch import tracing
from sbdart_tpu_torch.kernels import use_kernel
from sbdart_tpu_torch.kernels.blocktri_n2 import block_thomas_rt_n2
from sbdart_tpu_torch.kernels.blocktri_rt import block_thomas_rt, solve_step
from sbdart_tpu_torch.ops.lane import lmatmul as _mm
from sbdart_tpu_torch.ops.lane import lmatvec as _mv

# the reference's VMEM budget (pallas/blocktri.py:_tile_for_vmem) and its
# smallest lane tile
_VMEM_BUDGET = 12 * 1024 * 1024
_MIN_TILE = 128


def reference_streams(nlyr: int, n: int) -> bool:
    """Whether the reference's block_thomas_rt takes the streamed kernels
    at this shape (pallas/blocktri.py:693-703): the whole-column working
    set of one 128-lane tile exceeds the VMEM budget."""
    m = 2 * n
    floats = nlyr * (4 * n * n + 2 * n + 2 * 2 * m + m * m) + 2 * n * n
    return 4 * floats * _MIN_TILE > _VMEM_BUDGET


def reference_route(nlyr: int, n: int) -> str:
    """The kernel the reference's block_thomas_rt runs at (nlyr, n):
    "planar" (B2) at n = 2 while the planar working set of one 128-lane
    tile of 8 sublanes, 8 (60 nlyr + 8) floats a lane, fits the VMEM budget
    (pallas/blocktri.py:941-945: up to 51 layers); else "streamed" (B6)
    where `reference_streams`, else "full" (B5)."""
    if n == 2 and 4 * 8 * (60 * nlyr + 8) * _MIN_TILE <= _VMEM_BUDGET:
        return "planar"
    return "streamed" if reference_streams(nlyr, n) else "full"


def block_thomas_rt_fwd_plain(gp, gm, ee, refl, rhs):
    """Plain torch version of the forward kernel, any device and float
    dtype: a Python loop over layers on [2N, *, B] blocks, sums over a
    block index in order.  Returns (cs, ys)."""
    nlyr, n, _, b = gp.shape
    m = 2 * n
    new = dict(dtype=gp.dtype, device=gp.device)
    eye_bottom = torch.zeros((m, n, b), **new)
    eye_bottom[n:] = torch.eye(n, **new)[:, :, None]
    c_prev = torch.zeros((m, n, b), **new)
    y_prev = torch.zeros((m, b), **new)
    cs, ys = [], []
    for l in range(nlyr):
        gpl, gml, eel = gp[l], gm[l], ee[l]
        gpe, gme = gpl * eel[None], gml * eel[None]
        d_top = torch.cat([gml, gpe], dim=1)           # [N, 2N, B]
        last = 1.0 if l == nlyr - 1 else 0.0
        d_bot = torch.cat([gpe, gml], dim=1) - last * torch.cat(
            [_mm(refl, gme), _mm(refl, gpl)], dim=1)

        lm1 = max(l - 1, 0)
        neg_low = -(1.0 if l > 0 else 0.0)
        lt = neg_low * torch.cat([gm[lm1] * ee[lm1][None], gp[lm1]], dim=1)
        ub_prev = -torch.cat([gpl, gme], dim=1)        # [N, 2N, B]
        dt = torch.cat([d_top - _mm(_mm(lt, c_prev), ub_prev), d_bot])
        r_l = rhs[l]
        rt = torch.cat([r_l[:n] - _mv(lt, y_prev), r_l[n:]])

        sol = solve_step(dt, torch.cat([eye_bottom, rt[:, None, :]], dim=1))
        c_prev, y_prev = sol[:, :n], sol[:, n]
        cs.append(c_prev)
        ys.append(y_prev)
    return torch.stack(cs), torch.stack(ys)


def block_thomas_rt_bwd_plain(gp, gm, ee, cs, ys):
    """Plain torch version of the backward kernel: xs from the history."""
    nlyr = gp.shape[0]
    xs = [None] * nlyr
    xs[-1] = ys[-1]
    for l in range(nlyr - 2, -1, -1):
        ub = -torch.cat([gp[l + 1], gm[l + 1] * ee[l + 1][None]], dim=1)
        xs[l] = ys[l] - _mv(cs[l], _mv(ub, xs[l + 1]))
    return torch.stack(xs)


def block_thomas_rt_streamed_plain(gp, gm, ee, refl, rhs):
    """The whole B6 solve in plain torch: xs [L, 2N, B]."""
    return block_thomas_rt_bwd_plain(
        gp, gm, ee, *block_thomas_rt_fwd_plain(gp, gm, ee, refl, rhs))


def _check_shapes(name, n, want, tensors):
    if n < 1:
        raise ValueError(f"{name}: the kernel takes N >= 1, got {n}")
    for key, t in zip(want, tensors):
        if tuple(t.shape) != want[key]:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {want[key]}")


def _fwd_inputs(name, gp, gm, ee, refl, rhs):
    from sbdart_tpu_torch.kernels import _build

    nlyr, n, _, b = gp.shape
    _check_shapes(name, n, {
        "gp": (nlyr, n, n, b), "gm": (nlyr, n, n, b), "ee": (nlyr, n, b),
        "refl": (n, n, b), "rhs": (nlyr, 2 * n, b)}, (gp, gm, ee, refl, rhs))
    ins = [t.contiguous() for t in (gp, gm, ee, refl, rhs)]
    _build.require_cuda_f32(name, *ins)
    return ins


def _bwd_inputs(name, gp, gm, ee, cs, ys):
    from sbdart_tpu_torch.kernels import _build

    nlyr, n, _, b = gp.shape
    m = 2 * n
    _check_shapes(name, n, {
        "gp": (nlyr, n, n, b), "gm": (nlyr, n, n, b), "ee": (nlyr, n, b),
        "cs": (nlyr, m, n, b), "ys": (nlyr, m, b)}, (gp, gm, ee, cs, ys))
    ins = [t.contiguous() for t in (gp, gm, ee, cs, ys)]
    _build.require_cuda_f32(name, *ins)
    return ins


def _launch(name, entry, ins, outs, nlyr, n, b, extra=()):
    from sbdart_tpu_torch.kernels import _build

    lib = _build.library()
    with torch.cuda.device(ins[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, entry)(
            *(t.data_ptr() for t in ins + outs), *extra, nlyr, n, b, stream)
    _build.check(code, name)


# B6 forward's design by N: the one-thread-per-column kernel
# (blocktri_rt_streamed.cuh, built at these N only) at these N, the group
# kernel (blocktri_rt_streamed_group.cu) at every other N.  Both are timed
# by chip_smoke.py (PERF.md §6): the one-thread kernel is ahead at N = 2
# and 3, on the columns the reference streams there (480 layers x 49152
# columns, 250 x 12288) as at 65 and 33 layers; the group kernel is ahead
# from N = 4 on.
FWD_ONE_THREAD_N = frozenset({1, 2, 3})


def _fwd_kernel(name, entry, gp, gm, ee, refl, rhs, extra=()):
    ins = _fwd_inputs(name, gp, gm, ee, refl, rhs)
    nlyr, n, _, b = gp.shape
    new = dict(device=gp.device, dtype=torch.float32)
    cs = torch.empty((nlyr, 2 * n, n, b), **new)
    ys = torch.empty((nlyr, 2 * n, b), **new)
    _launch(name, entry, ins, [cs, ys], nlyr, n, b, extra)
    return cs, ys


def block_thomas_rt_fwd(gp, gm, ee, refl, rhs):
    """B6 forward: on CUDA tensors (float32 only) the one-thread CUDA
    kernel at the N of FWD_ONE_THREAD_N (the only N it is built at) and
    `block_thomas_rt_fwd_group` at every other N; the plain torch version
    on CPU tensors.  Returns (cs, ys)."""
    if not use_kernel(gp):
        return block_thomas_rt_fwd_plain(gp, gm, ee, refl, rhs)
    if gp.shape[1] not in FWD_ONE_THREAD_N:
        return block_thomas_rt_fwd_group(gp, gm, ee, refl, rhs)
    out = _fwd_kernel("block_thomas_rt_fwd", "sbdart_blocktri_rt_fwd", gp,
                      gm, ee, refl, rhs)
    tracing.count("kernels.block_thomas_rt_fwd.launches")
    return out


def block_thomas_rt_fwd_group(gp, gm, ee, refl, rhs):
    """B6 forward on a group of lanes per column, any N (the CUDA kernel of
    csrc/blocktri_rt_streamed_group.cu on CUDA tensors, float32 only; the
    plain torch version on CPU tensors).  Returns (cs, ys)."""
    if not use_kernel(gp):
        return block_thomas_rt_fwd_plain(gp, gm, ee, refl, rhs)
    from sbdart_tpu_torch.kernels import _build

    name = "block_thomas_rt_fwd_group"
    entry = "sbdart_blocktri_rt_fwd_group"
    nlyr, n, _, b = gp.shape
    _check_shapes(name, n, {}, ())
    # refused where one column's system does not fit the card's shared
    # memory (the rest moves to device scratch past the whole column)
    lib = _build.library()
    _build.require_shared_memory(
        name, lambda k: lib.sbdart_blocktri_rt_streamed_group_bytes(2, k), n,
        gp.device)
    scratch = _build.group_scratch(lib, entry, n, b, gp.device)
    out = _fwd_kernel(name, entry, gp, gm, ee, refl, rhs,
                      [_build.ptr(scratch)])
    tracing.count("kernels.block_thomas_rt_fwd_group.launches")
    return out


# B6 backward's design by N: the N at which one thread per column would
# run instead of the lane group kernel (blocktri_rt_bwd.cu).  None: the
# lane group kernel was ahead of the one-thread kernel at every N timed on
# the main path's shapes (chip_smoke.py's bwd_rule shapes N = 2, 3, 8, and
# its --ab against the one-thread kernel to N = 8; PERF.md §6), so no
# one-thread backward kernel is built, and an N put here has none to run.
BWD_ONE_THREAD_N = frozenset()


def bwd_entry(n: int) -> str:
    """The C entry that runs B6 backward at N = n: the lane group
    kernel's at every N outside BWD_ONE_THREAD_N; inside it a ValueError,
    as no one-thread backward kernel is built."""
    if n in BWD_ONE_THREAD_N:
        raise ValueError(f"block_thomas_rt_bwd: no one-thread kernel is "
                         f"built for N = {n}")
    return "sbdart_blocktri_rt_bwd_group"


def block_thomas_rt_bwd(gp, gm, ee, cs, ys):
    """B6 backward through its route, `bwd_entry`: on CUDA tensors
    `block_thomas_rt_bwd_group` at every N outside BWD_ONE_THREAD_N (which
    is empty); the plain torch version on CPU tensors.  Returns xs."""
    if not use_kernel(gp):
        return block_thomas_rt_bwd_plain(gp, gm, ee, cs, ys)
    bwd_entry(gp.shape[1])   # raises where BWD_ONE_THREAD_N routes away
    return block_thomas_rt_bwd_group(gp, gm, ee, cs, ys)


def block_thomas_rt_bwd_group(gp, gm, ee, cs, ys):
    """B6 backward on a lane group per column, any N up to the one whose
    layer slot fills the card's shared memory (the CUDA kernel of
    csrc/blocktri_rt_bwd.cu on CUDA tensors, float32 only; the plain torch
    version on CPU tensors).  Returns xs."""
    if not use_kernel(gp):
        return block_thomas_rt_bwd_plain(gp, gm, ee, cs, ys)
    from sbdart_tpu_torch.kernels import _build

    name = "block_thomas_rt_bwd_group"
    ins = _bwd_inputs(name, gp, gm, ee, cs, ys)
    nlyr, n, _, b = gp.shape
    # refused where one layer slot of one column does not fit
    _build.require_shared_memory(
        name, _build.library().sbdart_blocktri_rt_bwd_group_bytes, n,
        gp.device)
    xs = torch.empty((nlyr, 2 * n, b), device=gp.device, dtype=torch.float32)
    _launch(name, "sbdart_blocktri_rt_bwd_group", ins, [xs], nlyr, n, b)
    tracing.count("kernels.block_thomas_rt_bwd_group.launches")
    return xs


def block_thomas_rt_streamed(gp, gm, ee, refl, rhs):
    """The whole B6 solve: forward then backward, each through its
    wrapper.  Returns xs [L, 2N, B]."""
    return block_thomas_rt_bwd(
        gp, gm, ee, *block_thomas_rt_fwd(gp, gm, ee, refl, rhs))


def solve_bvp(gp, gm, ee, refl, rhs):
    """The boundary-value solve through the wrapper of the kernel the
    reference runs at this shape (`reference_route`).  Returns xs
    [L, 2N, B]."""
    solve = {
        "planar": block_thomas_rt_n2,
        "full": block_thomas_rt,
        "streamed": block_thomas_rt_streamed,
    }[reference_route(gp.shape[0], gp.shape[1])]
    return solve(gp, gm, ee, refl, rhs)
