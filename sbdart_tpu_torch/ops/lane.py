"""Lane-layout batched small linear algebra (torch port of the subset of
sbdart_tpu/ops/lane.py that the thermal particular solution needs).

Lane layout puts the tiny matrix dims first and the flattened batch last:

    matrices  [n, n, B]     vectors  [n, B]     scalars  [B]

so every row, column or entry access is one [B] vector op.
"""

from __future__ import annotations

import torch


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
