"""B2 (nstr=4 fused SETMTX + SOLVE0): the port's plain torch version
against the JAX package's block_thomas_rt in interpret mode (which takes
its n = 2 planar kernel), and against a dense float64 solve.

Inputs are the conditioned problems of tests/test_pallas_kernels.py
(_rt_problem, n = 2 cases, coupling 0.4).  Kernel-to-kernel bar: the
reference's interpret bar rtol 1e-5 / atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbdart_tpu.pallas.blocktri import block_thomas_rt
from sbdart_tpu_torch.kernels.blocktri_n2 import (
    block_thomas_rt_n2,
    block_thomas_rt_n2_plain,
)


def rt_problem(nlyr, n, b, *, coupling, seed=7):
    """Same generator as tests/test_pallas_kernels.py:_rt_problem."""
    rng = np.random.default_rng(seed)
    gm = rng.normal(size=(nlyr, n, n, b)) * 0.3 \
        + 2.0 * np.eye(n)[None, :, :, None]
    gp = rng.normal(size=(nlyr, n, n, b)) * coupling
    ee = rng.uniform(0.05, min(1.0, 2.0 * coupling), size=(nlyr, n, b))
    refl = rng.uniform(0.0, 0.3, size=(n, n, b))
    rhs = rng.normal(size=(nlyr, 2 * n, b))
    return gp, gm, ee, refl, rhs


def dense_solve(gp, gm, ee, refl, rhs):
    """The assembled block-tridiagonal system solved densely per column
    (SETMTX layout: top rows of layer l couple to layer l-1's bottom)."""
    nlyr, n, _, b = gp.shape
    m = 2 * n
    xs = np.zeros((nlyr, m, b))
    for c in range(b):
        a = np.zeros((nlyr * m, nlyr * m))
        for l in range(nlyr):
            gp_l, gm_l = gp[l, :, :, c], gm[l, :, :, c]
            e = ee[l, :, c]
            gpe, gme = gp_l * e[None, :], gm_l * e[None, :]
            d = np.block([[gm_l, gpe], [gpe, gm_l]])
            if l == nlyr - 1:
                r = refl[:, :, c]
                d[n:, :n] -= r @ gme
                d[n:, n:] -= r @ gp_l
            a[l * m:(l + 1) * m, l * m:(l + 1) * m] = d
            if l > 0:
                gp_m, gm_m = gp[l - 1, :, :, c], gm[l - 1, :, :, c]
                a[l * m:l * m + n, (l - 1) * m:l * m] = -np.hstack(
                    [gm_m * ee[l - 1, :, c][None, :], gp_m]
                )
            if l < nlyr - 1:
                gp_p, gm_p = gp[l + 1, :, :, c], gm[l + 1, :, :, c]
                a[l * m + n:(l + 1) * m, (l + 1) * m:(l + 2) * m] = -np.hstack(
                    [gp_p, gm_p * ee[l + 1, :, c][None, :]]
                )
        xs[:, :, c] = np.linalg.solve(a, rhs[:, :, c].reshape(-1)) \
            .reshape(nlyr, m)
    return xs


@pytest.mark.parametrize("nlyr,b", [(33, 300), (2, 700)])
def test_blocktri_n2_plain_matches_pallas_interpret(nlyr, b):
    prob = [x.astype(np.float32)
            for x in rt_problem(nlyr, 2, b, coupling=0.4)]
    ref = np.asarray(block_thomas_rt(*(jnp.asarray(x) for x in prob),
                                     interpret=True))
    got = block_thomas_rt_n2_plain(*(torch.from_numpy(x) for x in prob))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("nlyr,b", [(33, 24), (1, 10)])
def test_blocktri_n2_plain_solves_assembled_system_f64(nlyr, b):
    """The elimination solves the SETMTX system: float64 against a dense
    LAPACK solve, to roundoff (measured ~1e-15; bar 1e-11 of max|x|)."""
    prob = rt_problem(nlyr, 2, b, coupling=0.4, seed=3)
    want = dense_solve(*prob)
    got = block_thomas_rt_n2(*(torch.from_numpy(x) for x in prob)).numpy()
    assert np.abs(got - want).max() <= 1e-11 * np.abs(want).max()
