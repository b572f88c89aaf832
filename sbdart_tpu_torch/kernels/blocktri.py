"""B10: block-Thomas elimination on blocks assembled beforehand.

Port of sbdart_tpu/pallas/blocktri.py:_kernel (entry block_thomas).  The
block-tridiagonal system diag/lower/upper [L, m, m, B], rhs [L, m, B]
(m = 2N, the blocks of solver/bvp.py:assemble_blocks) is solved column by
column with the full W history:

    forward   (diag_l - lower_l W_{l-1}) [W_l | y_l]
                  = [upper_l | r_l - lower_l y_{l-1}]     (solve_step)
    backward  x_{L-1} = y_{L-1};  x_l = y_l - W_l x_{l+1}

with kernels/blocktri_rt.py:solve_step (the reference's _solve_step:
first-max implicit pivoting, shrinking elimination).  `block_thomas`
launches a CUDA kernel of csrc/block_thomas.cu on CUDA tensors
(`thomas_entry` names it by m: one thread per column at the m of
BT_ONE_THREAD_M, `block_thomas_group`, a group of lanes per column, at
every other m) and runs `block_thomas_plain` on CPU tensors.  The
reference pads the columns with identity blocks and refuses shapes beyond
its VMEM; neither is a limit here.  Returns xs [L, m, B].
"""

from __future__ import annotations

import torch

from sbdart_tpu_torch import tracing
from sbdart_tpu_torch.kernels import use_kernel
from sbdart_tpu_torch.kernels.blocktri_rt import solve_step
from sbdart_tpu_torch.ops.lane import lmatmul as _mm
from sbdart_tpu_torch.ops.lane import lmatvec as _mv

# B10's design by m: the one-thread-per-column kernel (built at these m
# only) at these m, the group kernel at every other m.  chip_smoke.py's
# bt_rule phase times both designs at the m the scan route sends B10
# (PERF.md §6): one thread is ahead at m = 4 only.
BT_ONE_THREAD_M = frozenset({4})


def thomas_entry(m: int) -> str:
    """The C entry that runs B10 at block size m (see BT_ONE_THREAD_M)."""
    if m in BT_ONE_THREAD_M:
        return "sbdart_block_thomas"
    return "sbdart_block_thomas_group"


def block_thomas_plain(diag, lower, upper, rhs):
    """Plain torch version of the B10 kernel, any device and float dtype:
    a Python loop over layers, sums over a block index in order."""
    nlyr, m, _, b = diag.shape
    w_prev = torch.zeros((m, m, b), dtype=diag.dtype, device=diag.device)
    y_prev = torch.zeros((m, b), dtype=diag.dtype, device=diag.device)
    ws, ys = [], []
    for l in range(nlyr):
        dt = diag[l] - _mm(lower[l], w_prev)
        rt = rhs[l] - _mv(lower[l], y_prev)
        sol = solve_step(dt, torch.cat([upper[l], rt[:, None, :]], dim=1))
        w_prev, y_prev = sol[:, :m], sol[:, m]
        ws.append(w_prev)
        ys.append(y_prev)
    xs = [None] * nlyr
    xs[-1] = y_prev
    for l in range(nlyr - 2, -1, -1):
        xs[l] = ys[l] - _mv(ws[l], xs[l + 1])
    return torch.stack(xs, dim=0)


def _launch(name, entry, diag, lower, upper, rhs):
    """Check the operands and launch one of B10's two kernels; xs."""
    from sbdart_tpu_torch.kernels import _build

    nlyr, m, _, b = diag.shape
    want = {"diag": (nlyr, m, m, b), "lower": (nlyr, m, m, b),
            "upper": (nlyr, m, m, b), "rhs": (nlyr, m, b)}
    for key, t in zip(want, (diag, lower, upper, rhs)):
        if tuple(t.shape) != want[key]:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {want[key]}")
    ins = [t.contiguous() for t in (diag, lower, upper, rhs)]
    _build.require_cuda_f32(name, *ins)
    lib = _build.library()
    extra, scratch = [], None
    if entry == "sbdart_block_thomas_group":
        _build.require_shared_memory(
            name, lambda k: lib.sbdart_block_thomas_group_bytes(k, 1), m,
            diag.device, what="m")
        # held until the launch is queued: its memory must not go to ws
        scratch = _build.group_scratch(lib, entry, m, b, diag.device)
        extra = [_build.ptr(scratch)]
    new = dict(device=diag.device, dtype=torch.float32)
    ws = torch.empty((nlyr, m * m, b), **new)          # W history scratch
    ys = torch.empty((nlyr, m, b), **new)
    xs = torch.empty((nlyr, m, b), **new)
    with torch.cuda.device(diag.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, entry)(
            *(t.data_ptr() for t in ins), ws.data_ptr(), ys.data_ptr(),
            xs.data_ptr(), *extra, nlyr, m, b, stream,
        )
    _build.check(code, name)
    return xs


def block_thomas(diag, lower, upper, rhs):
    """B10 on CUDA tensors (float32 only): the one-thread-per-column
    kernel at the m of BT_ONE_THREAD_M, `block_thomas_group` at every
    other m; the plain torch version on CPU tensors."""
    if not use_kernel(diag):
        return block_thomas_plain(diag, lower, upper, rhs)
    if thomas_entry(diag.shape[1]) == "sbdart_block_thomas_group":
        return block_thomas_group(diag, lower, upper, rhs)
    xs = _launch("block_thomas", "sbdart_block_thomas", diag, lower, upper,
                 rhs)
    tracing.count("kernels.block_thomas.launches")
    return xs


def block_thomas_group(diag, lower, upper, rhs):
    """B10 on a group of lanes per column, any m >= 1 (the CUDA kernels of
    csrc/block_thomas.cu on CUDA tensors, float32 only: rows in registers
    at even m <= 8, the system in shared memory past that; the plain
    torch version on CPU tensors)."""
    if not use_kernel(diag):
        return block_thomas_plain(diag, lower, upper, rhs)
    if diag.shape[1] < 1:
        raise ValueError(f"block_thomas_group: the kernel takes m >= 1, got "
                         f"{diag.shape[1]}")
    xs = _launch("block_thomas_group", "sbdart_block_thomas_group", diag,
                 lower, upper, rhs)
    tracing.count("kernels.block_thomas_group.launches")
    return xs
