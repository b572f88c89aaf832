"""B2: fused SETMTX + SOLVE0 for nstr=4 (n = 2), block-Thomas over layers.

Port of sbdart_tpu/pallas/blocktri.py:_rt_kernel_planar (reached via
block_thomas_rt's n = 2 branch).  `block_thomas_rt_n2` launches the CUDA
kernel csrc/blocktri_rt_n2.cu on CUDA tensors and runs
`block_thomas_rt_n2_plain`, the same math in plain torch with the same
operation order, on CPU tensors.

Inputs gp/gm [L, 2, 2, B] (G+-), ee [L, 2, B] (exp(-k dtau) per mode),
refl [2, 2, B] (surface operator R[i, k] w_k mu_k), rhs [L, 4, B];
returns xs [L, 4, B].
"""

from __future__ import annotations

import torch


def _solve4(dt, rhs_cols):
    """Pivoted shrinking elimination (blocktri.py:_planar_solve4).

    dt: 4x4 nested list of [B] tensors (dt[i][j] = row i, column j);
    rhs_cols: list of r columns, each a list of 4 row tensors.  The pivot
    is the first row of maximal |leading entry| among uneliminated rows.
    Returns x[i][t]: row i of the solution for right-hand side t.
    """
    m = 4
    aug = [[dt[i][j] for i in range(m)] for j in range(m)] + \
        [list(col) for col in rhs_cols]
    elim = [None] * m
    prows = []
    for _ in range(m):
        lead = aug[0]
        cand = []
        for i in range(m):
            ci = torch.abs(lead[i])
            if elim[i] is not None:
                ci = torch.where(elim[i], -1.0, ci)
            cand.append(ci)
        mx = torch.maximum(torch.maximum(cand[0], cand[1]),
                           torch.maximum(cand[2], cand[3]))
        sel = []
        taken = None
        for i in range(m):
            s_i = cand[i] == mx
            if taken is not None:
                s_i = s_i & ~taken
                taken = taken | s_i
            else:
                taken = s_i
            sel.append(s_i)
        pv = 0.0
        for i in range(m):
            pv = pv + torch.where(sel[i], lead[i], 0.0)
        inv = 1.0 / pv
        fac = []
        for i in range(m):
            mask = sel[i] if elim[i] is None else (elim[i] | sel[i])
            fac.append(torch.where(mask, 0.0, lead[i] * inv))
        tail = []
        new_aug = []
        for col in aug[1:]:
            rp = 0.0
            for i in range(m):
                rp = rp + torch.where(sel[i], col[i], 0.0)
            tail.append(rp)
            new_aug.append([col[i] - fac[i] * rp for i in range(m)])
        aug = new_aug
        prows.append((pv, tail))
        elim = [sel[i] if elim[i] is None else (elim[i] | sel[i])
                for i in range(m)]
    r = len(rhs_cols)
    x = [None] * m
    for i in reversed(range(m)):
        pv, tail = prows[i]            # tail: a_{i,i+1..3} then r rhs cols
        s = list(tail[m - i - 1:])
        for j in range(i + 1, m):
            aij = tail[j - i - 1]
            s = [s[t] - aij * x[j][t] for t in range(r)]
        x[i] = [s[t] / pv for t in range(r)]
    return x


def block_thomas_rt_n2_plain(gp, gm, ee, refl, rhs):
    """Plain torch version of the B2 kernel, any device and float dtype.
    Loops over layers in Python; every per-column quantity is a [B]
    tensor."""
    nlyr = gp.shape[0]
    rmat = [[refl[0, 0], refl[0, 1]], [refl[1, 0], refl[1, 1]]]

    def mats(l):
        g, h, e = gp[l], gm[l], ee[l]
        gp2 = [[g[0, 0], g[0, 1]], [g[1, 0], g[1, 1]]]
        gm2 = [[h[0, 0], h[0, 1]], [h[1, 0], h[1, 1]]]
        gpe = [[gp2[i][j] * e[j] for j in range(2)] for i in range(2)]
        gme = [[gm2[i][j] * e[j] for j in range(2)] for i in range(2)]
        return gp2, gm2, gpe, gme

    zero = torch.zeros_like(rhs[0, 0])
    w_prev = [[zero] * 4 for _ in range(4)]
    y_prev = [zero] * 4
    ws, ys = [], []
    for l in range(nlyr):
        gp2, gm2, gpe, gme = mats(l)
        last = 1.0 if l == nlyr - 1 else 0.0
        # diag = [[gm, gpe], [gpe, gm]] - last * [[0, 0], [R gme, R gp]]
        d = [[None] * 4 for _ in range(4)]
        for i in range(2):
            for j in range(2):
                d[i][j] = gm2[i][j]
                d[i][2 + j] = gpe[i][j]
                rg_me = rmat[i][0] * gme[0][j] + rmat[i][1] * gme[1][j]
                rg_p = rmat[i][0] * gp2[0][j] + rmat[i][1] * gp2[1][j]
                d[2 + i][j] = gpe[i][j] - last * rg_me
                d[2 + i][2 + j] = gm2[i][j] - last * rg_p

        # lower block rows (from layer l - 1)
        neg_low = -(1.0 if l > 0 else 0.0)
        gpm, _, _, gmem = mats(max(l - 1, 0))
        lt = [[None] * 4 for _ in range(2)]
        for i in range(2):
            for j in range(2):
                lt[i][j] = neg_low * gmem[i][j]
                lt[i][2 + j] = neg_low * gpm[i][j]

        rt = [rhs[l, i] for i in range(4)]
        dt = [[d[i][j] for j in range(4)] for i in range(4)]
        for i in range(2):
            corr_r = lt[i][0] * y_prev[0]
            for k in range(1, 4):
                corr_r = corr_r + lt[i][k] * y_prev[k]
            rt[i] = rt[i] - corr_r
            for j in range(4):
                corr = lt[i][0] * w_prev[0][j]
                for k in range(1, 4):
                    corr = corr + lt[i][k] * w_prev[k][j]
                dt[i][j] = dt[i][j] - corr

        # upper block (bottom rows, from layer l + 1)
        neg_up = -(1.0 if l < nlyr - 1 else 0.0)
        gpp, _, _, gmep = mats(min(l + 1, nlyr - 1))
        ucols = []
        for j in range(4):
            col = [zero, zero, None, None]
            for i in range(2):
                col[2 + i] = (neg_up * gpp[i][j] if j < 2
                              else neg_up * gmep[i][j - 2])
            ucols.append(col)

        x = _solve4(dt, ucols + [rt])
        w_prev = [[x[i][j] for j in range(4)] for i in range(4)]
        y_prev = [x[i][4] for i in range(4)]
        ws.append(w_prev)
        ys.append(y_prev)

    xs = [None] * nlyr
    xs[nlyr - 1] = y_prev
    for l in range(nlyr - 2, -1, -1):
        x_next = xs[l + 1]
        x_l = []
        for r in range(4):
            s = ws[l][r][0] * x_next[0]
            for j in range(1, 4):
                s = s + ws[l][r][j] * x_next[j]
            x_l.append(ys[l][r] - s)
        xs[l] = x_l
    return torch.stack([torch.stack(x, dim=0) for x in xs], dim=0)


def block_thomas_rt_n2(gp, gm, ee, refl, rhs):
    """B2 solve: the CUDA kernel on CUDA tensors (float32 only), the plain
    torch version on CPU tensors.  Shapes as in the module doc."""
    if gp.device.type == "cpu":
        return block_thomas_rt_n2_plain(gp, gm, ee, refl, rhs)
    from sbdart_tpu_torch.kernels import _build

    nlyr, b = gp.shape[0], gp.shape[-1]
    want = {"gp": (nlyr, 2, 2, b), "gm": (nlyr, 2, 2, b), "ee": (nlyr, 2, b),
            "refl": (2, 2, b), "rhs": (nlyr, 4, b)}
    for name, t in zip(want, (gp, gm, ee, refl, rhs)):
        if tuple(t.shape) != want[name]:
            raise ValueError(
                f"block_thomas_rt_n2: {name} has shape {tuple(t.shape)}, "
                f"expected {want[name]}"
            )
    ins = [t.contiguous() for t in (gp, gm, ee, refl, rhs)]
    _build.require_cuda_f32("block_thomas_rt_n2", *ins)
    new = dict(device=gp.device, dtype=torch.float32)
    ws = torch.empty((nlyr, 16, b), **new)
    ys = torch.empty((nlyr, 4, b), **new)
    xs = torch.empty((nlyr, 4, b), **new)
    lib = _build.library()
    with torch.cuda.device(gp.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.sbdart_blocktri_rt_n2(
            *(t.data_ptr() for t in ins), ws.data_ptr(), ys.data_ptr(),
            xs.data_ptr(), nlyr, b, stream,
        )
    block_thomas_rt_n2.launches += 1
    _build.check(code, "block_thomas_rt_n2")
    return xs


block_thomas_rt_n2.launches = 0
