"""ops/lane.py and ops/batched_linalg.py against the JAX package's, on the
same numpy inputs from a seeded generator.

  * float64: every primitive within 1e-12 (relative to the output's
    largest magnitude) of the reference's.  Eigenvectors from LAPACK
    (the "xla" methods) are compared after a sign normalisation (the
    largest-magnitude entry of each column made positive); the lane
    methods run the same rotations as the reference and are compared as
    they come.
  * float32: the lane eigensolver and solves against the reference's
    lane methods, eigenvalues within 1e-5 and eigenvectors within 1e-4 of
    the largest magnitude (two float32 evaluations of the same sweeps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbdart_tpu.ops import batched_linalg as ref_bl
from sbdart_tpu.ops import lane as ref_lane
from sbdart_tpu_torch.ops import batched_linalg as bl
from sbdart_tpu_torch.ops import lane


def spd(n, b, seed=0):
    """[n, n, b] symmetric positive definite matrices (lane layout)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(b, n, n))
    m = a @ a.transpose(0, 2, 1) + n * np.eye(n)
    return np.moveaxis(m, 0, -1)


def sym(n, b, seed=1):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(b, n, n))
    return np.moveaxis(0.5 * (a + a.transpose(0, 2, 1)), 0, -1)


def close(got, ref, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)
    assert err <= tol, err


def sign_fixed(v, axis):
    """Eigenvector columns with their largest-magnitude entry positive
    (`axis` indexes the entries of a column)."""
    v = np.asarray(v)
    idx = np.expand_dims(np.argmax(np.abs(v), axis=axis), axis)
    return v * np.sign(np.take_along_axis(v, idx, axis=axis))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8])
def test_lane_primitives_f64(n):
    a = spd(n, 7)
    b = np.random.default_rng(2).normal(size=(n, 3, 7))
    ta, tb = torch.tensor(a), torch.tensor(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    close(lane.ltranspose(ta), ref_lane.ltranspose(ja), 0.0)
    l = lane.lcholesky(ta)
    close(l, ref_lane.lcholesky(ja), 1e-12)
    u = lane.ltranspose(l)
    close(lane.lsolve_upper_tri(u, tb),
          ref_lane.lsolve_upper_tri(jnp.asarray(u.numpy()), jb), 1e-12)
    close(lane.lsolve(ta, tb), ref_lane.lsolve(ja, jb), 1e-12)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8, 16])
def test_leigh_f64_matches_reference(n):
    """Closed form at n = 1, 2; parallel-ordered Jacobi at even n, cyclic
    at odd n; sorted ascending."""
    a = sym(n, 9)
    w, v = lane.leigh(torch.tensor(a))
    w_r, v_r = ref_lane.leigh(jnp.asarray(a))
    close(w, w_r, 1e-12)
    close(v, v_r, 1e-12)
    assert np.all(np.diff(w.numpy(), axis=0) >= 0)


def test_lane_helpers_match_reference():
    for n in (2, 3, 4, 6, 8, 16):
        assert lane._round_robin_pairs(n) == ref_lane._round_robin_pairs(n)
    rng = np.random.default_rng(3)
    w = rng.normal(size=(5, 11))
    v = rng.normal(size=(5, 5, 11))
    got = lane._sort_ascending(torch.tensor(w), torch.tensor(v))
    ref = ref_lane._sort_ascending(jnp.asarray(w), jnp.asarray(v))
    for g, r in zip(got, ref):
        close(g, r, 0.0)
    a = sym(2, 13)
    for g, r in zip(lane._eigh2(torch.tensor(a)),
                    ref_lane._eigh2(jnp.asarray(a))):
        close(g, r, 1e-13)


@pytest.mark.parametrize("method", ["xla", "lane", "jacobi"])
@pytest.mark.parametrize("n", [3, 4, 7])
def test_eigh_small_f64(method, n):
    a = np.moveaxis(sym(n, 6), -1, 0).reshape(2, 3, n, n)
    w, v = bl.eigh_small(torch.tensor(a), method)
    w_r, v_r = ref_bl.eigh_small(jnp.asarray(a), method)
    close(w, w_r, 1e-12)
    if method == "xla":
        close(sign_fixed(v.numpy(), -2), sign_fixed(v_r, -2), 1e-12)
    else:
        close(v, v_r, 1e-12)


@pytest.mark.parametrize("method", ["xla", "lane", "unrolled"])
def test_gauss_solve_and_cholesky_small_f64(method):
    n = 5
    a = np.moveaxis(spd(n, 6), -1, 0).reshape(2, 3, n, n)
    b = np.random.default_rng(4).normal(size=(2, 3, n, 2))
    close(bl.gauss_solve(torch.tensor(a), torch.tensor(b), method),
          ref_bl.gauss_solve(jnp.asarray(a), jnp.asarray(b), method), 1e-12)
    close(bl.cholesky_small(torch.tensor(a), method),
          ref_bl.cholesky_small(jnp.asarray(a), method), 1e-12)


def test_batched_auto_picks_xla_on_the_cpu():
    """"auto" is "lane" only on the card (the reference: on its TPU)."""
    a = torch.tensor(np.moveaxis(spd(4, 3), -1, 0))
    w, v = bl.eigh_small(a)
    w_x, v_x = torch.linalg.eigh(a)
    assert torch.equal(w, w_x) and torch.equal(v, v_x)
    assert torch.equal(bl.cholesky_small(a), torch.linalg.cholesky(a))


def test_xla_eigh_slices_large_batches_on_the_card(monkeypatch):
    """On the card the "xla" eigh runs in slices of CUDA_EIGH_BATCH
    matrices (cuSOLVER's batched syev refuses 2^15 and more); the slices
    reassemble to the unsliced result, batch shape and all."""
    a = torch.tensor(np.moveaxis(sym(4, 30, seed=2), -1, 0).reshape(2, 3, 5,
                                                                      4, 4))
    monkeypatch.setattr(bl, "_on_card", lambda t: True)
    monkeypatch.setattr(bl, "CUDA_EIGH_BATCH", 7)
    w, v = bl.eigh_small(a, "xla")
    w_x, v_x = torch.linalg.eigh(a)
    assert w.shape == w_x.shape and v.shape == v_x.shape
    close(w, w_x.numpy(), 1e-13)
    close(sign_fixed(v.numpy(), -2), sign_fixed(v_x.numpy(), -2), 1e-12)


@pytest.mark.parametrize("n", [2, 3, 5, 8])
def test_lane_f32_matches_reference_lane(n):
    a = sym(n, 64, seed=5).astype(np.float32)
    w, v = lane.leigh(torch.tensor(a))
    w_r, v_r = ref_lane.leigh(jnp.asarray(a))
    close(w, w_r, 1e-5)
    close(v, v_r, 1e-4)
    s = spd(n, 64, seed=6).astype(np.float32)
    b = np.random.default_rng(7).normal(size=(n, 2, 64)).astype(np.float32)
    close(lane.lsolve(torch.tensor(s), torch.tensor(b)),
          ref_lane.lsolve(jnp.asarray(s), jnp.asarray(b)), 1e-5)
    close(lane.lcholesky(torch.tensor(s)), ref_lane.lcholesky(jnp.asarray(s)),
          1e-6)
