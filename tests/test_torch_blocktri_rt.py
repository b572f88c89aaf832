"""B5 and B6 (general-n fused SETMTX + SOLVE0, full-W and rank-N factor
history): the port's plain torch versions against the JAX package in
interpret mode, B5 against block_thomas_rt at n = 4, 6 and 8 with layer
counts small enough that the reference takes its whole-column kernel
(_rt_kernel), and at n = 2 with the reference's planar entry declined (as
it declines it from 52 layers on), B6 against the reference's streamed
kernels (_block_thomas_rt_streamed) with several layer chunks, at n = 2
too, both against a dense float64 solve.  The port picks B2, B5 and B6
exactly where the reference does (`reference_route`).

Inputs are the conditioned problems of tests/test_pallas_kernels.py
(_rt_problem).  Kernel-to-kernel bar: the reference's interpret bar
rtol 1e-5 / atol 1e-6 (tests/test_pallas_kernels.py:66-69).  Pivoting
(tests/test_pallas_kernels.py:157-171) is checked twice: the shared
elimination step against the reference's _solve_step, and the whole
solve on a column whose first pivot needs a row exchange.
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from launch_counts import launches
from test_torch_blocktri_n2 import dense_solve, rt_problem

from sbdart_tpu_torch import kernels
from sbdart_tpu_torch.kernels.blocktri_n2 import block_thomas_rt_n2_plain

import sbdart_tpu.pallas.blocktri as ref_blocktri
from sbdart_tpu.pallas.blocktri import _solve_step as ref_solve_step
from sbdart_tpu.pallas.blocktri import block_thomas_rt as ref_block_thomas_rt
from sbdart_tpu_torch.kernels.blocktri_rt import (
    block_thomas_rt,
    block_thomas_rt_plain,
    solve_step,
)
from sbdart_tpu_torch.kernels.blocktri_rt_streamed import (
    BWD_ONE_THREAD_N,
    block_thomas_rt_bwd,
    block_thomas_rt_bwd_group,
    block_thomas_rt_fwd,
    block_thomas_rt_fwd_plain,
    block_thomas_rt_streamed,
    block_thomas_rt_streamed_plain,
    bwd_entry,
    reference_route,
    reference_streams,
    solve_bvp,
)


@pytest.mark.parametrize("nlyr,n,b,coupling", [
    (5, 4, 128, 0.4), (9, 4, 130, 0.4), (6, 8, 130, 0.15), (2, 8, 40, 0.4),
    (5, 6, 130, 0.3), (3, 9, 8, 0.3), (2, 10, 6, 0.3),
])
def test_blocktri_rt_plain_matches_pallas_interpret(nlyr, n, b, coupling):
    prob = [x.astype(np.float32)
            for x in rt_problem(nlyr, n, b, coupling=coupling)]
    ref = np.asarray(ref_block_thomas_rt(*(jnp.asarray(x) for x in prob),
                                         interpret=True))
    got = block_thomas_rt_plain(*(torch.from_numpy(x) for x in prob))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_blocktri_rt_plain_matches_pallas_interpret_n2(monkeypatch):
    """B5 at N = 2 against the reference's _rt_kernel, which its
    block_thomas_rt runs at n = 2 when the planar entry returns None."""
    monkeypatch.setattr(ref_blocktri, "_block_thomas_rt_planar_n2",
                        lambda *a, **k: None)
    prob = [x.astype(np.float32)
            for x in rt_problem(6, 2, 130, coupling=0.4)]
    ref = np.asarray(ref_block_thomas_rt(*(jnp.asarray(x) for x in prob),
                                         interpret=True))
    got = block_thomas_rt_plain(*(torch.from_numpy(x) for x in prob))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("nlyr,n,b", [(7, 4, 12), (4, 8, 6), (1, 6, 5),
                                      (9, 2, 7), (3, 9, 4), (2, 10, 3)])
def test_blocktri_rt_plain_solves_assembled_system_f64(nlyr, n, b):
    """The elimination solves the SETMTX system: float64 against a dense
    LAPACK solve, to roundoff (bar 1e-11 of max |x|)."""
    prob = rt_problem(nlyr, n, b, coupling=0.4, seed=3)
    want = dense_solve(*prob)
    got = block_thomas_rt(*(torch.from_numpy(x) for x in prob)).numpy()
    assert np.abs(got - want).max() <= 1e-11 * np.abs(want).max()


def test_blocktri_rt_plain_pivots_at_reference_f32_floor():
    """A zero top-left entry of the first diagonal block (gm[0][0] of layer
    0) in every lane: the first elimination step must exchange rows.  The
    system this makes is ill-conditioned (max |x| 6.8e3 from O(1) data), so,
    as in tests/test_pallas_kernels.py:74-112, both float32 routes are held
    against a dense float64 solve: each at the conditioning floor (< 5e-3
    normwise), the port no worse than twice the reference (measured 2.6e-5
    against 1.3e-4)."""
    prob = [x.astype(np.float32)
            for x in rt_problem(4, 4, 130, coupling=0.4, seed=9)]
    prob[1][0, 0, 0, :] = 0.0
    prob[1][0, 1, 0, :] = 3.0
    truth = dense_solve(*(x.astype(np.float64) for x in prob))
    ref = np.asarray(ref_block_thomas_rt(*(jnp.asarray(x) for x in prob),
                                         interpret=True))
    got = block_thomas_rt_plain(*(torch.from_numpy(x) for x in prob)).numpy()
    norm = np.abs(truth).max()
    err_ref = np.abs(ref - truth).max() / norm
    err_got = np.abs(got - truth).max() / norm
    assert np.isfinite(got).all()
    assert err_ref < 5e-3 and err_got < 5e-3, (err_got, err_ref)
    assert err_got <= 2.0 * err_ref + 1e-6, (err_got, err_ref)


def test_solve_step_pivots_like_reference():
    """A zero leading entry in every lane forces a row exchange at the
    first step; rows tied in |lead| take the first (the reference's
    argmax rule)."""
    rng = np.random.default_rng(5)
    m, r, b = 8, 3, 130
    dt = rng.normal(size=(m, m, b))
    dt[0, 0, :] = 0.0
    dt[1, 0, :] = 3.0
    dt[4, 0, ::2] = -3.0                  # a tie with row 1
    rhs = rng.normal(size=(m, r, b))
    args = [x.astype(np.float32) for x in (dt, rhs)]
    ref = np.asarray(ref_solve_step(*(jnp.asarray(a) for a in args)))
    got = solve_step(*(torch.from_numpy(a) for a in args)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    x64 = solve_step(torch.from_numpy(dt), torch.from_numpy(rhs)).numpy()
    np.testing.assert_allclose(np.einsum("ijb,jkb->ikb", dt, x64), rhs,
                               atol=1e-10)


def test_blocktri_rt_wrapper_takes_plain_version_on_cpu():
    prob = [torch.from_numpy(x.astype(np.float32))
            for x in rt_problem(3, 4, 9, coupling=0.4)]
    before = launches(block_thomas_rt)
    assert torch.equal(block_thomas_rt(*prob), block_thomas_rt_plain(*prob))
    assert launches(block_thomas_rt) == before


@pytest.mark.parametrize("nlyr,n,b,coupling,chunk", [
    (5, 4, 130, 0.4, 2), (9, 6, 20, 0.4, 4), (6, 6, 40, 0.3, 6),
    (7, 8, 16, 0.15, 3), (7, 2, 130, 0.4, 3), (5, 9, 8, 0.3, 2),
    (4, 10, 6, 0.3, 3),
])
def test_blocktri_rt_streamed_plain_matches_pallas_interpret(
        nlyr, n, b, coupling, chunk):
    """B6 against the reference's two streamed kernels, with layer chunks
    that leave padded layers (5 = 2 + 2 + 1, 9, 7) and one that does not."""
    prob = [x.astype(np.float32)
            for x in rt_problem(nlyr, n, b, coupling=coupling)]
    ref = np.asarray(ref_blocktri._block_thomas_rt_streamed(
        *(jnp.asarray(x) for x in prob), tile_b=512, interpret=True,
        layer_chunk=chunk))
    got = block_thomas_rt_streamed_plain(*(torch.from_numpy(x) for x in prob))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("nlyr,n,b", [(7, 4, 12), (4, 8, 6), (5, 6, 5),
                                      (1, 4, 3), (6, 2, 9), (3, 9, 4),
                                      (2, 10, 3)])
def test_blocktri_rt_streamed_plain_solves_assembled_system_f64(nlyr, n, b):
    prob = rt_problem(nlyr, n, b, coupling=0.4, seed=3)
    want = dense_solve(*prob)
    got = block_thomas_rt_streamed(
        *(torch.from_numpy(x) for x in prob)).numpy()
    assert np.abs(got - want).max() <= 1e-11 * np.abs(want).max()


def test_blocktri_rt_streamed_plain_pivots_at_reference_f32_floor():
    """The row-exchange case above, through B6 and the reference's
    streamed kernels (two chunks of two layers)."""
    prob = [x.astype(np.float32)
            for x in rt_problem(4, 4, 130, coupling=0.4, seed=9)]
    prob[1][0, 0, 0, :] = 0.0
    prob[1][0, 1, 0, :] = 3.0
    truth = dense_solve(*(x.astype(np.float64) for x in prob))
    ref = np.asarray(ref_blocktri._block_thomas_rt_streamed(
        *(jnp.asarray(x) for x in prob), tile_b=512, interpret=True,
        layer_chunk=2))
    got = block_thomas_rt_streamed_plain(
        *(torch.from_numpy(x) for x in prob)).numpy()
    norm = np.abs(truth).max()
    err_ref = np.abs(ref - truth).max() / norm
    err_got = np.abs(got - truth).max() / norm
    assert np.isfinite(got).all()
    assert err_ref < 5e-3 and err_got < 5e-3, (err_got, err_ref)
    assert err_got <= 2.0 * err_ref + 1e-6, (err_got, err_ref)


@pytest.mark.parametrize("n,first", [(4, 147), (6, 71), (8, 42), (9, 34),
                                     (10, 28), (16, 11), (20, 7)])
def test_streams_where_the_reference_streams(monkeypatch, n, first):
    """reference_streams against the reference's own routing, observed by
    tracing block_thomas_rt abstractly with its streamed entry recorded."""
    taken = []

    def record(gp, gm, ee, refl, rhs, **_):
        taken.append(gp.shape[0])
        return jnp.zeros(rhs.shape, rhs.dtype)

    monkeypatch.setattr(ref_blocktri, "_block_thomas_rt_streamed", record)
    route = functools.partial(ref_block_thomas_rt.__wrapped__,
                              interpret=True)
    for nlyr in (1, first - 1, first, first + 23):
        spec = jax.ShapeDtypeStruct
        f32 = jnp.float32
        taken.clear()
        jax.eval_shape(route, spec((nlyr, n, n, 3), f32),
                       spec((nlyr, n, n, 3), f32), spec((nlyr, n, 3), f32),
                       spec((n, n, 3), f32), spec((nlyr, 2 * n, 3), f32))
        assert bool(taken) == reference_streams(nlyr, n), (n, nlyr)
        assert reference_streams(nlyr, n) == (nlyr >= first)


def test_routes_where_the_reference_routes_at_n2(monkeypatch):
    """reference_route at n = 2 against the reference's own choice, traced
    abstractly with its planar and streamed entries recorded: the planar
    kernel (B2) up to 51 layers, _rt_kernel (B5) from 52 to 472, the
    streamed kernels (B6) from 473."""
    taken = []
    planar = ref_blocktri._block_thomas_rt_planar_n2

    def record_planar(*a, **k):
        xs = planar(*a, **k)
        taken.append("planar" if xs is not None else "declined")
        return xs

    def record_streamed(gp, gm, ee, refl, rhs, **_):
        taken.append("streamed")
        return jnp.zeros(rhs.shape, rhs.dtype)

    monkeypatch.setattr(ref_blocktri, "_block_thomas_rt_planar_n2",
                        record_planar)
    monkeypatch.setattr(ref_blocktri, "_block_thomas_rt_streamed",
                        record_streamed)
    route = functools.partial(ref_block_thomas_rt.__wrapped__,
                              interpret=True)
    spec = jax.ShapeDtypeStruct
    f32 = jnp.float32
    want = {1: "planar", 51: "planar", 52: "full", 472: "full",
            473: "streamed"}
    for nlyr, name in want.items():
        taken.clear()
        jax.eval_shape(route, spec((nlyr, 2, 2, 3), f32),
                       spec((nlyr, 2, 2, 3), f32), spec((nlyr, 2, 3), f32),
                       spec((2, 2, 3), f32), spec((nlyr, 4, 3), f32))
        seen = "full" if taken == ["declined"] else taken[-1]
        assert seen == name == reference_route(nlyr, 2), (nlyr, taken)


@pytest.mark.parametrize("n,nlyr", [(2, 33), (2, 52), (2, 473), (8, 41),
                                    (8, 42)])
def test_solve_bvp_runs_the_routed_kernel(n, nlyr):
    """solve_bvp gives the routed plain version's result bit for bit."""
    prob = [torch.from_numpy(x.astype(np.float32))
            for x in rt_problem(nlyr, n, 3, coupling=0.4)]
    plain = {"planar": block_thomas_rt_n2_plain, "full": block_thomas_rt_plain,
             "streamed": block_thomas_rt_streamed_plain}
    want = plain[reference_route(nlyr, n)](*prob)
    with kernels.plain():
        assert torch.equal(solve_bvp(*prob), want)
    assert torch.equal(solve_bvp(*prob), want)


def test_blocktri_rt_streamed_wrappers_take_plain_versions_on_cpu():
    prob = [torch.from_numpy(x.astype(np.float32))
            for x in rt_problem(3, 6, 9, coupling=0.4)]
    before = (launches(block_thomas_rt_fwd),
              launches(block_thomas_rt_bwd_group))
    cs, ys = block_thomas_rt_fwd(*prob)
    cs_p, ys_p = block_thomas_rt_fwd_plain(*prob)
    assert cs.shape == (3, 12, 6, 9) and ys.shape == (3, 12, 9)
    assert torch.equal(cs, cs_p) and torch.equal(ys, ys_p)
    assert torch.equal(block_thomas_rt_bwd(*prob[:3], cs, ys),
                       block_thomas_rt_streamed_plain(*prob))
    assert (launches(block_thomas_rt_fwd),
            launches(block_thomas_rt_bwd_group)) == before


@pytest.mark.parametrize("n", range(1, 25))
def test_blocktri_rt_bwd_entry_by_n(n):
    """B6 backward's choice of kernel by N: the lane group kernel at every
    N outside BWD_ONE_THREAD_N, and a refusal inside it, where no
    one-thread kernel is built to run."""
    if n in BWD_ONE_THREAD_N:
        with pytest.raises(ValueError, match="no one-thread kernel"):
            bwd_entry(n)
    else:
        assert bwd_entry(n) == "sbdart_blocktri_rt_bwd_group"


def test_blocktri_rt_bwd_one_thread_instances_are_the_routed_n():
    """The CUDA sources hold a one-thread backward kernel (its kernel or
    its C entry `sbdart_blocktri_rt_bwd`) exactly when BWD_ONE_THREAD_N
    routes an N to one (at none, as the set is empty), and the lane group
    kernel has an instance at every N to 16, N a run-time argument past
    it: no N routed to a kernel is missing, none is dead."""
    csrc = Path(block_thomas_rt_bwd.__code__.co_filename).parent / "csrc"
    one_thread = re.compile(r"\bblocktri_rt_bwd_kernel\b|"
                            r"\bsbdart_blocktri_rt_bwd\s*\(")
    holders = {p.name for p in csrc.iterdir()
               if p.suffix in (".cu", ".cuh")
               and one_thread.search(p.read_text())}
    assert bool(holders) == bool(BWD_ONE_THREAD_N), holders
    src = (csrc / "blocktri_rt_bwd.cu").read_text()
    group = {int(x) for x in re.findall(
        r"^\s*SBDART_BWD_GROUP_CASE\((\d+)\)", src, re.M)}
    assert group == set(range(1, 17))
    assert "launch<0>(" in src
