"""The port's solve_rte (nstr=4 solar flux slice) against the JAX
package's, on the same NumPy inputs.

  * float64: against the reference's generic route (eig_method="xla",
    bvp_method="scan"), a different algorithm for the same DISORT
    equations, on the mode-invariant outputs.  Measured cross-route
    agreement on CPU: 6.0e-14 of each output's max at 6 and 33 layers;
    bar 1e-10.
  * float32: against the reference's own lane path (eig_method=
    "fused_interpret", the Pallas kernels B1/B2 in the interpreter),
    at the reference's bar 5e-4 of max (tests/test_pallas_kernels.py:
    364-368); measured 1.2e-5.
  * a conservative column (ssalb = 1, dithered): the solve is
    near-singular there, so routes that round differently part further
    (measured: float64 cross-route 4.9e-8, float32 port vs reference
    7.5e-4).  Float64 is held at 1e-6, and in float32 each route is
    held to the reference's own distance from the float64 truth.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbdart_tpu.solver.disort import solve_rte as ref_solve_rte
from sbdart_tpu_torch.convert import rte_inputs_to_torch
from sbdart_tpu_torch.solver.disort import solve_rte

OUTPUTS = ("rfldir", "rfldn", "flup", "dfdt", "uavg")


def flux_problem(nlyr, nbc, nk=2, seed=0, conservative=False):
    """Batch (band-column, k-term) inputs: dtau U(0.001, 0.6), ssalb
    U(0.05, 0.999) (column 3 at ssalb = 1 if `conservative`), HG moments
    of g U(0, 0.85) shared by the k-terms, 20% of columns without a beam,
    some isotropic top illumination."""
    rng = np.random.default_rng(seed)
    dtau = rng.uniform(0.001, 0.6, (nbc, nk, nlyr))
    ssalb = rng.uniform(0.05, 0.999, (nbc, nk, nlyr))
    if conservative:
        ssalb[3] = 1.0
    g = rng.uniform(0.0, 0.85, (nbc, 1, nlyr))
    pmom = g[..., None] ** np.arange(5)
    kw = dict(
        fbeam=np.where(rng.uniform(size=(nbc, 1)) < 0.8, 1.0, 0.0),
        umu0=rng.uniform(0.2, 1.0, (nbc, 1)),
        albedo=rng.uniform(0.0, 0.8, (nbc, 1)),
        fisot=np.where(rng.uniform(size=(nbc, 1)) < 0.3, 0.1, 0.0),
    )
    return (dtau, ssalb, pmom), kw


def _rel_err(got, ref):
    got = got.numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _ref_f64(args, kw):
    return ref_solve_rte(*(jnp.asarray(a) for a in args), nstr=4,
                         **{k: jnp.asarray(v) for k, v in kw.items()},
                         onlyfl=True, dtype=jnp.float64, eig_method="xla",
                         bvp_method="scan")


def _ref_f32(args, kw):
    return ref_solve_rte(*(jnp.asarray(a, jnp.float32) for a in args),
                         nstr=4,
                         **{k: jnp.asarray(v, jnp.float32)
                            for k, v in kw.items()},
                         onlyfl=True, dtype=jnp.float32,
                         eig_method="fused_interpret")


@pytest.mark.parametrize("nlyr", [6, 33])
def test_solve_rte_f64_matches_reference_generic_route(nlyr):
    args, kw = flux_problem(nlyr, 16)
    ref = _ref_f64(args, kw)
    t = rte_inputs_to_torch(dtype=torch.float64, device="cpu", **kw)
    got = solve_rte(*args, nstr=4, **t, onlyfl=True, dtype=torch.float64)
    for name in OUTPUTS:
        assert getattr(got, name).dtype == torch.float64
        err = _rel_err(getattr(got, name), getattr(ref, name))
        assert err < 1e-10, (name, err)
    assert got.uu is None


def test_solve_rte_f32_matches_reference_lane_path():
    args, kw = flux_problem(6, 16)
    ref = _ref_f32(args, kw)
    got = solve_rte(*args, nstr=4, **kw, onlyfl=True, dtype=torch.float32)
    for name in OUTPUTS:
        assert getattr(got, name).dtype == torch.float32
        err = _rel_err(getattr(got, name), getattr(ref, name))
        assert err < 5e-4, (name, err)


def test_solve_rte_conservative_column_at_reference_floor():
    args, kw = flux_problem(6, 16, conservative=True)
    truth = _ref_f64(args, kw)
    ref32 = _ref_f32(args, kw)
    got64 = solve_rte(*args, nstr=4, **kw, dtype=torch.float64)
    got32 = solve_rte(*args, nstr=4, **kw, dtype=torch.float32)
    for name in OUTPUTS:
        t = np.asarray(getattr(truth, name))
        err64 = _rel_err(getattr(got64, name), t)
        assert err64 < 1e-6, (name, err64)
        err_port = _rel_err(getattr(got32, name), t)
        err_ref = np.abs(np.asarray(getattr(ref32, name)) - t).max() \
            / np.abs(t).max()
        assert err_port <= 2.0 * err_ref + 1e-6, (name, err_port, err_ref)


def test_solve_rte_routes_agree_and_unaligned_batch_stays_finite():
    """eig_method 'plain' and 'auto' are the same math on CPU; an
    unaligned batch of 130 columns with conservative and beam-free lanes
    gives finite outputs in float32 (the reference's padding trap)."""
    args, kw = flux_problem(5, 65, nk=2, seed=2, conservative=True)
    auto = solve_rte(*args, nstr=4, **kw, dtype=torch.float32)
    plain = solve_rte(*args, nstr=4, **kw, dtype=torch.float32,
                      eig_method="plain")
    for name in OUTPUTS:
        a, p = getattr(auto, name), getattr(plain, name)
        assert a.shape == (65, 2, 6)
        assert torch.isfinite(a).all() and torch.equal(a, p)
    with pytest.raises(ValueError, match="eig_method"):
        solve_rte(*args, nstr=4, **kw, eig_method="fused")
