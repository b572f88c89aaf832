"""The port's solve_rte (flux-only, nstr 4/8/16, solar and thermal)
against the JAX package's, on the same NumPy inputs.

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
  * nstr 4 with the thermal source, 8, 12 and 16 solar and thermal,
    on the reference's _fused_flux_problem
    (tests/test_pallas_kernels.py:325-346, 6 layers x 16 columns): float32
    against its fused_interpret route at its bar 5e-4 (measured 9e-7 to
    6.7e-5), float64 against its xla route at 1e-10 (measured 3e-15 to
    5e-13; the float64 route runs the plain versions with 6 Jacobi
    sweeps);
  * nstr 16 at 42 layers, the first layer count at which the reference
    streams its BVP solve (B6, rank-N history) and the port follows it:
    the same bars (measured float32 9.7e-7 to 5.0e-6, float64 4.5e-15 to
    2.0e-14);
  * the optically thin thermal band of tests/test_f32_path.py:147-183:
    float32 within 1e-2 of the float64 route and of the reference's
    float64 (the slope floor at work).
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
    got = solve_rte(*args, nstr=4, **t, onlyfl=True, dtype=torch.float64,
                    device="cpu")
    for name in OUTPUTS:
        assert getattr(got, name).dtype == torch.float64
        err = _rel_err(getattr(got, name), getattr(ref, name))
        assert err < 1e-10, (name, err)
    assert got.uu is None


def test_solve_rte_f32_matches_reference_lane_path():
    args, kw = flux_problem(6, 16)
    ref = _ref_f32(args, kw)
    got = solve_rte(*args, nstr=4, **kw, onlyfl=True, dtype=torch.float32,
                    device="cpu")
    for name in OUTPUTS:
        assert getattr(got, name).dtype == torch.float32
        err = _rel_err(getattr(got, name), getattr(ref, name))
        assert err < 5e-4, (name, err)


def test_solve_rte_conservative_column_at_reference_floor():
    args, kw = flux_problem(6, 16, conservative=True)
    truth = _ref_f64(args, kw)
    ref32 = _ref_f32(args, kw)
    got64 = solve_rte(*args, nstr=4, **kw, dtype=torch.float64, device="cpu")
    got32 = solve_rte(*args, nstr=4, **kw, dtype=torch.float32, device="cpu")
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
    auto = solve_rte(*args, nstr=4, **kw, dtype=torch.float32, device="cpu")
    plain = solve_rte(*args, nstr=4, **kw, dtype=torch.float32,
                      eig_method="plain", device="cpu")
    for name in OUTPUTS:
        a, p = getattr(auto, name), getattr(plain, name)
        assert a.shape == (65, 2, 6)
        assert torch.isfinite(a).all() and torch.equal(a, p)
    with pytest.raises(ValueError, match="eig_method"):
        solve_rte(*args, nstr=4, **kw, eig_method="fused", device="cpu")


def fused_flux_problem(nstr, nlyr, b, planck, seed=0):
    """tests/test_pallas_kernels.py:_fused_flux_problem as NumPy arrays."""
    rng = np.random.default_rng(seed)
    dtau = rng.uniform(0.001, 0.6, (b, nlyr))
    ssalb = rng.uniform(0.05, 0.999, (b, nlyr))
    g = rng.uniform(0.0, 0.85, (b, nlyr))
    pmom = g[..., None] ** np.arange(nstr + 1)
    kw = dict(fbeam=np.where(rng.uniform(size=b) < 0.8, 1.0, 0.0),
              umu0=rng.uniform(0.2, 1.0, (b,)),
              albedo=rng.uniform(0.0, 0.8, (b,)))
    if planck:
        kw.update(temper=np.linspace(250, 290, nlyr + 1)[None].repeat(b, 0),
                  fisot=0.3)
    return (dtau, ssalb, pmom), kw


PLANCK_KW = dict(planck=True, wvnlo=800.0, wvnhi=900.0, btemp=290.0)
CASES = [(4, True), (8, False), (12, False), (12, True), (16, False),
         (16, True), (8, True)]
_REF = {}


def _reference(nstr, planck, nlyr=6):
    """The reference's float32 fused_interpret and float64 xla solves."""
    if (nstr, planck, nlyr) not in _REF:
        args, kw = fused_flux_problem(nstr, nlyr, 16, planck)
        extra = PLANCK_KW if planck else {}
        r32 = ref_solve_rte(
            *(jnp.asarray(a, jnp.float32) for a in args), nstr=nstr,
            **{k: jnp.asarray(v, jnp.float32) for k, v in kw.items()},
            **extra, onlyfl=True, dtype=jnp.float32,
            eig_method="fused_interpret")
        r64 = ref_solve_rte(
            *(jnp.asarray(a) for a in args), nstr=nstr,
            **{k: jnp.asarray(v) for k, v in kw.items()}, **extra,
            onlyfl=True, dtype=jnp.float64, eig_method="xla",
            bvp_method="scan")
        _REF[nstr, planck, nlyr] = (args, kw, extra, r32, r64)
    return _REF[nstr, planck, nlyr]


@pytest.mark.parametrize("nstr,planck", CASES)
def test_solve_rte_general_f32_matches_reference_lane_path(nstr, planck):
    args, kw, extra, r32, _ = _reference(nstr, planck)
    got = solve_rte(*args, nstr=nstr, **kw, **extra, dtype=torch.float32,
                    device="cpu")
    for name in ("rfldn", "flup", "uavg", "dfdt"):
        assert getattr(got, name).dtype == torch.float32
        err = _rel_err(getattr(got, name), getattr(r32, name))
        assert err < 5e-4, (name, err)


@pytest.mark.parametrize("nstr,planck", CASES)
def test_solve_rte_general_f64_matches_reference_generic_route(nstr, planck):
    args, kw, extra, _, r64 = _reference(nstr, planck)
    got = solve_rte(*args, nstr=nstr, **kw, **extra, dtype=torch.float64,
                    device="cpu")
    for name in OUTPUTS:
        err = _rel_err(getattr(got, name), getattr(r64, name))
        assert err < 1e-10, (name, err)


def test_solve_rte_streamed_bvp_shape_matches_reference():
    from sbdart_tpu_torch.kernels.blocktri_rt_streamed import (
        reference_streams)

    assert reference_streams(42, 8) and not reference_streams(41, 8)
    args, kw, _, r32, r64 = _reference(16, False, nlyr=42)
    got32 = solve_rte(*args, nstr=16, **kw, dtype=torch.float32, device="cpu")
    got64 = solve_rte(*args, nstr=16, **kw, dtype=torch.float64, device="cpu")
    for name in ("rfldn", "flup", "uavg", "dfdt"):
        err = _rel_err(getattr(got32, name), getattr(r32, name))
        assert err < 5e-4, (name, err)
    for name in OUTPUTS:
        err = _rel_err(getattr(got64, name), getattr(r64, name))
        assert err < 1e-10, (name, err)


def test_f32_thermal_thin_band_tracks_f64():
    """Per-layer dtau 1e-7..1e-2 in a cold column, 20 cm^-1 band: without
    the float32 slope floor two correct float32 paths differed 3x here."""
    nlyr = 16
    rng = np.random.default_rng(12)
    dtau = 10.0 ** rng.uniform(-7.0, -2.0, nlyr)
    ssalb = np.full(nlyr, 1e-4)
    pmom = np.zeros((nlyr, 5))
    pmom[:, 0] = 1.0
    kw = dict(nstr=4, fbeam=0.0, umu0=1.0, albedo=0.05, planck=True,
              temper=np.linspace(211.0, 257.0, nlyr + 1), wvnlo=1660.0,
              wvnhi=1680.0, btemp=257.1, temis=0.0, onlyfl=True)
    ref64 = ref_solve_rte(*(jnp.asarray(a) for a in (dtau, ssalb, pmom)),
                          dtype=jnp.float64, eig_method="xla",
                          bvp_method="scan", **kw)
    got32 = solve_rte(dtau, ssalb, pmom, dtype=torch.float32, device="cpu",
                      **kw)
    got64 = solve_rte(dtau, ssalb, pmom, dtype=torch.float64, device="cpu",
                      **kw)
    for name in ("rfldn", "flup", "uavg"):
        a = getattr(got32, name).double().numpy()
        for truth in (getattr(got64, name).numpy(),
                      np.asarray(getattr(ref64, name))):
            err = np.abs(a - truth).max() / max(np.abs(truth).max(), 1e-3)
            assert err < 1e-2, (name, err)
