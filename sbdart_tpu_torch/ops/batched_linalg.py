"""Batched dense linear algebra for many tiny matrices (torch port of
sbdart_tpu/ops/batched_linalg.py).

The DOM solver needs, per (batch, mode, layer): a symmetric
eigendecomposition of an (n x n) matrix, n = nstr/2 (disort.f:ASYMTX after
the symmetrization of solver/eig.py), dense solves (UPBEAM's SGECO/SGESL)
and Cholesky factors of SPD matrices.  Batch sizes reach 10^5-10^7 while
n <= 16, so the lane methods vectorize across the batch and unroll across
n (ops/lane.py).  The "xla" methods are torch.linalg's, as the reference
leaves them to jnp.linalg; "auto" picks "lane" on the card where the
reference picks it on the TPU.
"""

from __future__ import annotations

import torch

from sbdart_tpu_torch.ops import lane


# torch.linalg.eigh on a CUDA tensor (cuSOLVER's batched syev) refuses
# batches of 2^15 matrices and more with CUSOLVER_STATUS_INVALID_VALUE
# (torch 2.11 + CUDA 12.8 on the H100; 16384 passes), so the card gets the
# batch in slices of this many matrices, each solved on its own.
CUDA_EIGH_BATCH = 16384


def _on_card(a: torch.Tensor) -> bool:
    return a.device.type == "cuda"


def _xla_eigh(a: torch.Tensor):
    n = a.shape[-1]
    flat = a.reshape(-1, n, n)
    if not _on_card(a) or flat.shape[0] <= CUDA_EIGH_BATCH:
        return torch.linalg.eigh(a)
    parts = [torch.linalg.eigh(x) for x in flat.split(CUDA_EIGH_BATCH)]
    w = torch.cat([p[0] for p in parts]).reshape(a.shape[:-1])
    v = torch.cat([p[1] for p in parts]).reshape(a.shape)
    return w, v


def jacobi_eigh(a: torch.Tensor, sweeps: int = 10):
    """Batched symmetric eigendecomposition of [..., n, n] by cyclic Jacobi
    rotations (batch-major): (w [..., n] ascending, v [..., n, n] with
    columns v[..., :, j])."""
    n = a.shape[-1]
    if n == 1:
        return a[..., 0], torch.ones_like(a)
    eps = torch.finfo(a.dtype).eps
    a = a.clone()
    v = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape).clone()
    for _ in range(sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                app, aqq, apq = a[..., p, p], a[..., q, q], a[..., p, q]
                small = torch.abs(apq) <= eps * torch.clamp_min(
                    torch.abs(app) + torch.abs(aqq), eps)
                tau = (aqq - app) / (2.0 * torch.where(small, 1.0, apq))
                t = torch.sign(tau) / (torch.abs(tau)
                                       + torch.sqrt(1.0 + tau * tau))
                t = torch.where(torch.sign(tau) == 0,
                                1.0 / (tau + torch.sqrt(1.0 + tau * tau)), t)
                t = torch.where(small, 0.0, t)
                c = 1.0 / torch.sqrt(1.0 + t * t)
                s = t * c
                rp, rq = a[..., p, :].clone(), a[..., q, :].clone()
                a[..., p, :] = c[..., None] * rp - s[..., None] * rq
                a[..., q, :] = s[..., None] * rp + c[..., None] * rq
                cp, cq = a[..., :, p].clone(), a[..., :, q].clone()
                a[..., :, p] = c[..., None] * cp - s[..., None] * cq
                a[..., :, q] = s[..., None] * cp + c[..., None] * cq
                vp, vq = v[..., :, p].clone(), v[..., :, q].clone()
                v[..., :, p] = c[..., None] * vp - s[..., None] * vq
                v[..., :, q] = s[..., None] * vp + c[..., None] * vq
    w = torch.diagonal(a, dim1=-2, dim2=-1)
    order = torch.argsort(w, dim=-1)
    w = torch.take_along_dim(w, order, dim=-1)
    v = torch.take_along_dim(v, order[..., None, :], dim=-1)
    return w, v


def eigh_small(a: torch.Tensor, method: str = "auto"):
    """Batched symmetric eigendecomposition with backend selection:
    "xla" (torch.linalg.eigh), "lane" (ops/lane.py:leigh, n <= 16),
    "jacobi" (batch-major Jacobi) or "auto" (lane on the card, else xla)."""
    n = a.shape[-1]
    if method == "auto":
        method = "lane" if (_on_card(a) and n <= 16) else "xla"
    if method == "lane":
        al, batch_shape = lane.to_lane(a)
        w, v = lane.leigh(al)
        return lane.from_lane(w, batch_shape), lane.from_lane(v, batch_shape)
    if method == "jacobi":
        return jacobi_eigh(a)
    return _xla_eigh(a)


def gauss_solve(a: torch.Tensor, b: torch.Tensor,
                method: str = "auto") -> torch.Tensor:
    """Solve a @ x = b for batched small a [..., n, n], b [..., n, m]:
    "lane" (ops/lane.py:lsolve), "xla" (torch.linalg.solve), "unrolled"
    (batch-major pivoted elimination) or "auto" (lane on the card for
    n <= 48, else xla)."""
    n = a.shape[-1]
    if method == "auto":
        method = "lane" if (_on_card(a) and n <= 48) else "xla"
    if method == "lane":
        al, batch_shape = lane.to_lane(a)
        bl, _ = lane.to_lane(b)
        return lane.from_lane(lane.lsolve(al, bl), batch_shape)
    if method == "xla":
        return torch.linalg.solve(a, b)

    aug = torch.cat([a, b.to(a.dtype)], dim=-1)          # [..., n, n+m]
    rows = torch.arange(n, device=a.device)
    for k in range(n):
        col = torch.abs(aug[..., :, k])
        if k > 0:
            col = torch.where(rows >= k, col, -torch.inf)
        piv = torch.argmax(col, dim=-1)                   # [...]
        e_piv = torch.nn.functional.one_hot(piv, n).to(a.dtype)
        row_k = aug[..., k, :]
        row_p = torch.einsum("...n,...nm->...m", e_piv, aug)
        e_k = (rows == k).to(a.dtype)
        aug = (aug + e_k[:, None] * (row_p - row_k)[..., None, :]
               + e_piv[..., :, None] * (row_k - row_p)[..., None, :])
        inv = 1.0 / aug[..., k, k]
        factor = aug[..., :, k] * inv[..., None] * (rows > k).to(a.dtype)
        aug = aug - factor[..., :, None] * aug[..., k, :][..., None, :]
    x = [None] * n
    for k in reversed(range(n)):
        rhs = aug[..., k, n:]
        for j in range(k + 1, n):
            rhs = rhs - aug[..., k, j, None] * x[j]
        x[k] = rhs / aug[..., k, k, None]
    return torch.stack(x, dim=-2)


def cholesky_small(a: torch.Tensor, method: str = "auto") -> torch.Tensor:
    """Lower Cholesky factor of batched SPD [..., n, n]: "lane"
    (ops/lane.py:lcholesky), "xla" (torch.linalg.cholesky), "unrolled" or
    "auto" (lane on the card for n <= 32, else xla)."""
    n = a.shape[-1]
    if method == "auto":
        method = "lane" if (_on_card(a) and n <= 32) else "xla"
    if method == "lane":
        al, batch_shape = lane.to_lane(a)
        return lane.from_lane(lane.lcholesky(al), batch_shape)
    if method == "xla":
        return torch.linalg.cholesky(a)
    l = torch.zeros_like(a)
    for j in range(n):
        s = (torch.einsum("...k,...k->...", l[..., j, :j], l[..., j, :j])
             if j > 0 else torch.zeros_like(a[..., 0, 0]))
        d = torch.sqrt(a[..., j, j] - s)
        l[..., j, j] = d
        if j + 1 < n:
            s2 = (torch.einsum("...ik,...k->...i", l[..., j + 1:, :j],
                               l[..., j, :j])
                  if j > 0 else torch.zeros_like(a[..., j + 1:, j]))
            l[..., j + 1:, j] = (a[..., j + 1:, j] - s2) / d[..., None]
    return l
