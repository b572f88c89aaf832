# Frozen copy of sbdart_tpu_torch/ops/lane.py for the benchmark's reference: imports
# point into rtbench.reference.
# Later changes do not edit it.
"""Lane-layout batched small linear algebra (torch port of
sbdart_tpu/ops/lane.py).

Lane layout puts the tiny matrix dims first and the flattened batch last:

    matrices  [n, n, B]     vectors  [n, B]     scalars  [B]

so every row, column or entry access is one [B] vector op.  The n-loops
are Python loops over the tiny static n, as in the reference.
"""

from __future__ import annotations

import torch

from rtbench.reference.ops.graph import const, index


def to_lane(x: torch.Tensor, ndim_mat: int = 2) -> tuple[torch.Tensor, tuple]:
    """[..., n, n] -> [n, n, B] (or [..., n] -> [n, B]); returns the batch
    shape."""
    batch_shape = tuple(x.shape[: x.ndim - ndim_mat])
    mat_shape = tuple(x.shape[x.ndim - ndim_mat:])
    x = x.reshape((-1,) + mat_shape)
    return torch.movedim(x, 0, -1), batch_shape


def from_lane(x: torch.Tensor, batch_shape: tuple) -> torch.Tensor:
    """[n, ..., B] -> [batch..., n, ...]."""
    x = torch.movedim(x, -1, 0)
    return x.reshape(tuple(batch_shape) + tuple(x.shape[1:]))


def lmatmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., p, q, B] @ [..., q, r, B] -> [..., p, r, B], the q-sum taken
    in order (q = 0, 1, ...), so that a kernel summing in that order
    rounds alike."""
    s = a[..., :, 0, None, :] * b[..., None, 0, :, :]
    for k in range(1, a.shape[-2]):
        s = s + a[..., :, k, None, :] * b[..., None, k, :, :]
    return s


def lmatvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[..., p, q, B] @ [..., q, B] -> [..., p, B], the q-sum in order."""
    s = a[..., :, 0, :] * x[..., None, 0, :]
    for k in range(1, a.shape[-2]):
        s = s + a[..., :, k, :] * x[..., None, k, :]
    return s


def lsolve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a @ x = b, a [n, n, B], b [n, m, B]: pivoted GE, unrolled.

    Branchless partial pivoting as in the reference: the pivot row is the
    first row of maximal |column entry| among rows k.. (argmax), and rows
    are exchanged with masked selects, so the elimination rounds as the
    reference's does (torch.linalg.solve would pivot differently)."""
    n = a.shape[0]
    aug = torch.cat([a, b], dim=1)                 # [n, n+m, B]
    rows = torch.arange(n, device=a.device)[:, None]
    for k in range(n):
        col = torch.abs(aug[:, k, :])              # [n, B]
        if k > 0:
            col = torch.cat([torch.full_like(col[:k], -1.0), col[k:]])
        piv = torch.argmax(col, dim=0)             # [B]
        row_k = aug[k]                             # [n+m, B]
        sel = rows == piv[None, :]                 # [n, B]
        row_p = torch.sum(torch.where(sel[:, None, :], aug, 0.0), dim=0)
        is_k = piv == k                            # [B]
        aug = torch.where(sel[:, None, :] & ~is_k[None, None, :],
                          row_k[None], aug)
        new_k = torch.where(is_k[None, :], row_k, row_p)
        inv_piv = 1.0 / new_k[k]
        head = torch.cat([aug[:k], new_k[None]])
        if k + 1 < n:
            factor = aug[k + 1:, k, :] * inv_piv[None, :]   # [n-k-1, B]
            tail = aug[k + 1:] + (-factor[:, None, :] * new_k[None])
            aug = torch.cat([head, tail])
        else:
            aug = head
    x = [None] * n
    for i in reversed(range(n)):
        s = aug[i, n:]                             # [m, B]
        for j in range(i + 1, n):
            s = s - aug[i, j][None, :] * x[j]
        x[i] = s / aug[i, i][None, :]
    return torch.stack(x, dim=0)                   # [n, m, B]


def ltranspose(a: torch.Tensor) -> torch.Tensor:
    return torch.swapaxes(a, -3, -2)


def lcholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of SPD [n, n, B]; unrolled over the static n."""
    n = a.shape[0]
    rows = [[None] * n for _ in range(n)]
    for j in range(n):
        s = a[j, j]
        for k in range(j):
            s = s - rows[j][k] * rows[j][k]
        d = torch.sqrt(s)
        rows[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s2 = a[i, j]
            for k in range(j):
                s2 = s2 - rows[i][k] * rows[j][k]
            rows[i][j] = s2 * inv_d
        for k in range(j + 1, n):
            rows[j][k] = torch.zeros_like(d)
    return torch.stack([torch.stack(r, dim=0) for r in rows], dim=0)


def lsolve_upper_tri(u: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve U x = b with U upper-triangular [n, n, B], b [n, m, B]."""
    n = u.shape[0]
    x = [None] * n
    for i in reversed(range(n)):
        s = b[i]
        for k in range(i + 1, n):
            s = s - u[i, k][None, :] * x[k]
        x[i] = s / u[i, i][None, :]
    return torch.stack(x, dim=0)


def _eigh2(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Closed-form symmetric 2x2 eigendecomposition of [2, 2, B] (the
    arctan2 form of ops/lane.py:_eigh2), eigenvalues ascending."""
    p, q, d = a[0, 0], a[0, 1], a[1, 1]
    theta = 0.5 * torch.atan2(2.0 * q, p - d)
    c = torch.cos(theta)
    s = torch.sin(theta)
    wa = c * c * p + 2.0 * c * s * q + s * s * d     # for column (c, s)
    wb = s * s * p - 2.0 * c * s * q + c * c * d     # for column (-s, c)
    lo = wa <= wb
    w = torch.stack([torch.where(lo, wa, wb), torch.where(lo, wb, wa)])
    v = torch.stack([
        torch.stack([torch.where(lo, c, -s), torch.where(lo, -s, c)]),
        torch.stack([torch.where(lo, s, c), torch.where(lo, c, s)]),
    ])
    return w, v


def _sort_ascending(w: torch.Tensor, v: torch.Tensor):
    """Ascending eigenvalue sort by a static compare-swap (bubble) network
    on w [n, B] and the columns of v [n, n, B]."""
    n = w.shape[0]
    w = list(w.unbind(0))
    cols = list(v.unbind(1))
    for i in range(n - 1):
        for j in range(n - 1 - i):
            wj, wk = w[j], w[j + 1]
            swap = wj > wk
            w[j], w[j + 1] = torch.where(swap, wk, wj), torch.where(swap, wj,
                                                                    wk)
            vj, vk = cols[j], cols[j + 1]
            cols[j] = torch.where(swap[None, :], vk, vj)
            cols[j + 1] = torch.where(swap[None, :], vj, vk)
    return torch.stack(w), torch.stack(cols, dim=1)


def _round_robin_pairs(n: int) -> list[list[tuple[int, int]]]:
    """Tournament schedule: n-1 rounds of n/2 disjoint (p, q) pairs covering
    every unordered pair exactly once (parallel Jacobi ordering)."""
    players = list(range(n))
    rounds = []
    for _ in range(n - 1):
        rounds.append([
            tuple(sorted((players[i], players[n - 1 - i])))
            for i in range(n // 2)
        ])
        players = [players[0]] + [players[-1]] + players[1:-1]
    return rounds


def _rotation(app, aqq, apq, eps):
    """Jacobi rotation (c, s) annihilating apq (ops/lane.py:293-302)."""
    small = torch.abs(apq) <= eps * torch.clamp_min(
        torch.abs(app) + torch.abs(aqq), eps)
    tau = (aqq - app) / (2.0 * torch.where(small, 1.0, apq))
    sgn = torch.where(tau >= 0.0, 1.0, -1.0).to(tau.dtype)
    t = sgn / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
    t = torch.where(small, 0.0, t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, t * c


def _leigh_parallel(a: torch.Tensor, v: torch.Tensor, sweeps: int):
    """Parallel-ordered cyclic Jacobi for even n: each round applies the
    n/2 disjoint Givens rotations at once as whole-matrix ops."""
    n = a.shape[0]
    eps = torch.finfo(a.dtype).eps
    rounds = []
    for pairs in _round_robin_pairs(n):
        partner = [0] * n
        sgn = [0.0] * n
        pair_of = [0] * n
        for k, (p, q) in enumerate(pairs):
            partner[p], partner[q] = q, p
            sgn[p], sgn[q] = -1.0, 1.0
            pair_of[p] = pair_of[q] = k
        rounds.append((pairs, index(partner, a.device),
                       const(sgn, a.dtype, a.device),
                       index(pair_of, a.device)))
    for _ in range(sweeps):
        for pairs, prm, sgn, pair_of in rounds:
            app = torch.stack([a[p, p] for p, _ in pairs])    # [n/2, B]
            aqq = torch.stack([a[q, q] for _, q in pairs])
            apq = torch.stack([a[p, q] for p, q in pairs])
            c, s = _rotation(app, aqq, apq, eps)
            crow = c[pair_of]                                 # [n, B]
            srow = s[pair_of] * sgn[:, None]
            # rows: A <- J^T A, then columns: A <- A J; V rotates like A's
            # columns
            a = crow[:, None, :] * a + srow[:, None, :] * a[prm]
            a = crow[None, :, :] * a + srow[None, :, :] * a[:, prm]
            v = crow[None, :, :] * v + srow[None, :, :] * v[:, prm]
    w = torch.stack([a[i, i] for i in range(n)])
    return _sort_ascending(w, v)


def _leigh_cyclic(a: torch.Tensor, v: torch.Tensor, sweeps: int):
    """Cyclic (row-ordered) Jacobi, one rotation at a time: the odd-n
    route (ops/lane.py:289-322).  Updates in place on copies."""
    n = a.shape[0]
    eps = torch.finfo(a.dtype).eps
    a = a.clone()
    v = v.clone()
    for _ in range(sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                c, s = _rotation(a[p, p], a[q, q], a[p, q], eps)
                rp, rq = a[p].clone(), a[q].clone()
                a[p] = c * rp - s * rq
                a[q] = s * rp + c * rq
                cp, cq = a[:, p].clone(), a[:, q].clone()
                a[:, p] = c * cp - s * cq
                a[:, q] = s * cp + c * cq
                vp, vq = v[:, p].clone(), v[:, q].clone()
                v[:, p] = c * vp - s * vq
                v[:, q] = s * vp + c * vq
    w = torch.stack([a[i, i] for i in range(n)])
    return _sort_ascending(w, v)


def leigh(a: torch.Tensor, sweeps: int = 6) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Symmetric eigendecomposition of [n, n, B]: (w [n, B], v [n, n, B]),
    eigenvalues ascending and eigenvector columns v[:, j], as
    torch.linalg.eigh.  n = 1 and 2 are closed-form; even n runs the
    parallel-ordered Jacobi, odd n the cyclic one, `sweeps` sweeps (6, the
    reference's default: twice the measured convergence point)."""
    n = a.shape[0]
    if n == 1:
        return a[0], torch.ones_like(a)
    if n == 2:
        return _eigh2(a)
    v0 = torch.zeros_like(a) + torch.eye(n, dtype=a.dtype,
                                         device=a.device)[..., None]
    if n % 2 == 0:
        return _leigh_parallel(a, v0, sweeps)
    return _leigh_cyclic(a, v0, sweeps)
