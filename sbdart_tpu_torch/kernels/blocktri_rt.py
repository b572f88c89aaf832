"""B5: fused SETMTX + SOLVE0 for general n, block-Thomas over layers with
the full W history: a group of lanes per column (csrc/blocktri_rt_group.cu,
on the elimination core group_solve.cuh), except at the N of
RT_ONE_THREAD_N, where one thread per column runs it
(csrc/blocktri_rt.cu).

Port of sbdart_tpu/pallas/blocktri.py:_rt_kernel (reached via
block_thomas_rt for n >= 4, and at n = 2 where its planar tile does not
fit VMEM: see blocktri_rt_streamed.reference_route).  The 2N x 2N blocks are assembled on the fly
from G+-, the per-mode transmissions ee and the Lambertian surface
operator (blocktri.py:228-233):

    diag_l  = [[gm_l, gp_l e_l], [gp_l e_l, gm_l]]
              (last layer's bottom rows: - [R (gm e), R gp])
    lower_l = -[[gm_{l-1} e, gp_{l-1}], [0, 0]]          (l >= 1)
    upper_l = -[[0, 0], [gp_{l+1}, gm_{l+1} e]]          (l <= L-2)

The forward sweep solves (diag - lower W_{l-1}) [W_l | y_l] = [upper |
r - lower y_{l-1}] with `solve_step`; the backward sweep takes
x_l = y_l - W_l x_{l+1}.  `block_thomas_rt` launches a CUDA kernel on
CUDA tensors and runs `block_thomas_rt_plain` on CPU tensors.

Inputs gp/gm [L, N, N, B], ee [L, N, B], refl [N, N, B], rhs [L, 2N, B];
returns xs [L, 2N, B].
"""

from __future__ import annotations

import torch

from sbdart_tpu_torch import tracing
from sbdart_tpu_torch.kernels import use_kernel
from sbdart_tpu_torch.ops.lane import lmatmul as _mm
from sbdart_tpu_torch.ops.lane import lmatvec as _mv

# B5's design by N: the one-thread-per-column kernel (blocktri_rt.cu,
# built at these N only) at these N, the group kernel
# (blocktri_rt_group.cu) at every other N.  chip_smoke.py times both
# designs at the shapes the main path gives B5 (PERF.md §6).
RT_ONE_THREAD_N = frozenset({1, 2})


def solve_step(dt, rhs_aug):
    """Solve dt X = rhs_aug for dt [..., m, m, B], rhs_aug [..., m, r, B]
    (rows at dim -3), as pallas/blocktri.py:_solve_step: branchless GE
    with implicit pivoting (the pivot is the first row of maximal |leading
    entry| among rows not yet eliminated) and shrinking elimination (each
    step drops its pivot column).  Returns X [..., m, r, B]."""
    m = dt.shape[-3]
    aug = torch.cat([dt, rhs_aug], dim=-2)             # [..., m, m+r, B]
    rows = torch.arange(m, device=dt.device)[:, None]  # [m, 1]
    elim = torch.zeros(aug[..., 0, :].shape, dtype=torch.bool,
                       device=dt.device)               # [..., m, B]
    prows = []
    for _ in range(m):
        lead = aug[..., 0, :]                          # [..., m, B]
        col = torch.where(elim, -1.0, torch.abs(lead))
        piv = torch.argmax(col, dim=-2)                # [..., B]
        sel = rows == piv[..., None, :]                # [..., m, B]
        piv_val = torch.sum(torch.where(sel, lead, 0.0), dim=-2)
        tail = aug[..., 1:, :]                         # [..., m, w-1, B]
        row_t = torch.sum(torch.where(sel[..., None, :], tail, 0.0), dim=-3)
        inv_piv = 1.0 / piv_val
        factor = torch.where(elim | sel, 0.0, lead * inv_piv[..., None, :])
        aug = tail - factor[..., None, :] * row_t[..., None, :, :]
        elim = elim | sel
        prows.append((piv_val, row_t))
    # back substitution on the saved pivot rows: prows[i] = (pivot value,
    # [a_{i,i+1..m-1}, rhs_i]), so a_ij sits at offset j - i - 1 and the
    # rhs at m - i - 1
    x = [None] * m
    for i in reversed(range(m)):
        pv, rest = prows[i]
        s = rest[..., m - i - 1:, :]
        for j in range(i + 1, m):
            s = s - rest[..., j - i - 1, None, :] * x[j]
        x[i] = s / pv[..., None, :]
    return torch.stack(x, dim=-3)                      # [..., m, r, B]


def block_thomas_rt_plain(gp, gm, ee, refl, rhs):
    """Plain torch version of the B5 kernel, any device and float dtype:
    a Python loop over layers on [2N, 2N, B] blocks
    (pallas/blocktri.py:_rt_kernel), sums over a block index in order."""
    nlyr, n, _, b = gp.shape
    m = 2 * n

    def layer_mats(l):
        gpl, gml, eel = gp[l], gm[l], ee[l]
        return gpl, gml, gpl * eel[None], gml * eel[None]

    w_prev = torch.zeros((m, m, b), dtype=gp.dtype, device=gp.device)
    y_prev = torch.zeros((m, b), dtype=gp.dtype, device=gp.device)
    ws, ys = [], []
    for l in range(nlyr):
        gpl, gml, gpe, gme = layer_mats(l)
        d_top = torch.cat([gml, gpe], dim=1)           # [N, 2N, B]
        last = 1.0 if l == nlyr - 1 else 0.0
        d_bot = torch.cat([gpe, gml], dim=1) - last * torch.cat(
            [_mm(refl, gme), _mm(refl, gpl)], dim=1)

        _, _, _, gmem = layer_mats(max(l - 1, 0))
        gpm = gp[max(l - 1, 0)]
        neg_low = -(1.0 if l > 0 else 0.0)
        lt = neg_low * torch.cat([gmem, gpm], dim=1)   # [N, 2N, B]
        dt = torch.cat([d_top - _mm(lt, w_prev), d_bot])
        r_l = rhs[l]
        rt = torch.cat([r_l[:n] - _mv(lt, y_prev), r_l[n:]])

        gpp, _, _, gmep = layer_mats(min(l + 1, nlyr - 1))
        neg_up = -(1.0 if l < nlyr - 1 else 0.0)
        ub = neg_up * torch.cat([gpp, gmep], dim=1)    # [N, 2N, B]
        upper = torch.cat([torch.zeros_like(ub), ub])

        sol = solve_step(dt, torch.cat([upper, rt[:, None, :]], dim=1))
        w_prev, y_prev = sol[:, :m], sol[:, m]
        ws.append(w_prev)
        ys.append(y_prev)

    xs = [None] * nlyr
    xs[-1] = y_prev
    for l in range(nlyr - 2, -1, -1):
        xs[l] = ys[l] - _mv(ws[l], xs[l + 1])
    return torch.stack(xs, dim=0)


def _launch(name, entry, gp, gm, ee, refl, rhs):
    """Check the operands and launch one of B5's two kernels; xs."""
    from sbdart_tpu_torch.kernels import _build

    nlyr, n, _, b = gp.shape
    want = {"gp": (nlyr, n, n, b), "gm": (nlyr, n, n, b), "ee": (nlyr, n, b),
            "refl": (n, n, b), "rhs": (nlyr, 2 * n, b)}
    for key, t in zip(want, (gp, gm, ee, refl, rhs)):
        if tuple(t.shape) != want[key]:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {want[key]}")
    ins = [t.contiguous() for t in (gp, gm, ee, refl, rhs)]
    _build.require_cuda_f32(name, *ins)
    lib = _build.library()
    extra, scratch = [], None
    if entry == "sbdart_blocktri_rt_group":
        _build.require_shared_memory(
            name, lambda k: lib.sbdart_blocktri_rt_group_bytes(k, 1), n,
            gp.device)
        # held until the launch is queued: its memory must not go to ws
        scratch = _build.group_scratch(lib, entry, n, b, gp.device)
        extra = [_build.ptr(scratch)]
    m = 2 * n
    new = dict(device=gp.device, dtype=torch.float32)
    ws = torch.empty((nlyr, m * m, b), **new)          # W history scratch
    ys = torch.empty((nlyr, m, b), **new)
    xs = torch.empty((nlyr, m, b), **new)
    with torch.cuda.device(gp.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, entry)(
            *(t.data_ptr() for t in ins), ws.data_ptr(), ys.data_ptr(),
            xs.data_ptr(), *extra, nlyr, n, b, stream,
        )
    _build.check(code, name)
    return xs


def block_thomas_rt(gp, gm, ee, refl, rhs):
    """B5 solve on CUDA tensors (float32 only): the one-thread-per-column
    kernel at the N of RT_ONE_THREAD_N, `block_thomas_rt_group` at every
    other N; the plain torch version on CPU tensors.  Shapes as in the
    module doc."""
    if not use_kernel(gp):
        return block_thomas_rt_plain(gp, gm, ee, refl, rhs)
    n = gp.shape[1]
    if n not in RT_ONE_THREAD_N:
        return block_thomas_rt_group(gp, gm, ee, refl, rhs)
    xs = _launch("block_thomas_rt", "sbdart_blocktri_rt", gp, gm, ee, refl,
                 rhs)
    tracing.count("kernels.block_thomas_rt.launches")
    return xs


def block_thomas_rt_group(gp, gm, ee, refl, rhs):
    """B5 on a group of lanes per column, any N (the CUDA kernel of
    csrc/blocktri_rt_group.cu on CUDA tensors, float32 only; the plain
    torch version on CPU tensors)."""
    if not use_kernel(gp):
        return block_thomas_rt_plain(gp, gm, ee, refl, rhs)
    if gp.shape[1] < 1:
        raise ValueError(f"block_thomas_rt_group: the kernel takes N >= 1, "
                         f"got {gp.shape[1]}")
    xs = _launch("block_thomas_rt_group", "sbdart_blocktri_rt_group", gp, gm,
                 ee, refl, rhs)
    tracing.count("kernels.block_thomas_rt_group.launches")
    return xs
