"""The generic solver path as a whole: the port's solve_rte on requests
the lane paths do not take (odd N: nstr 2, 6, 10; N > 8: nstr 20;
flux-only solves on a BRDF surface; all-mode solves without user angles)
against the JAX package's, in float64, and run_pipeline at nstr=6.

The port's float64 generic route is the reference's CPU route
(eig_method="auto": torch.linalg eigh/Cholesky/solve, the lane
block-Thomas); the reference runs under one jax.jit (its pipeline jits
the same way).  Bar: 1e-9 of each field's max on the five flux fields and
uu (measured <= 5e-15).  tests/test_torch_generic_f32.py holds the float32
route against the reference's TPU route in interpret mode.

Inputs: tests/test_radlane.py's distributions from a seeded numpy
generator (tests/test_torch_radlane.py:radiance_problem), 3-4 layers, 2-3
columns, view cosines of both signs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbdart_tpu.config import Config as RefConfig
from sbdart_tpu.pipeline import run_pipeline as ref_run_pipeline
from sbdart_tpu.solver.disort import solve_rte as ref_solve_rte
from sbdart_tpu_torch.config import Config
from sbdart_tpu_torch.pipeline import run_pipeline
from test_torch_radlane import port, radiance_problem

FIELDS = ("rfldir", "rfldn", "flup", "dfdt", "uavg", "uu")


def generic_problem(nstr, nlyr=4, nbc=2, *, mode="flux", **kw):
    """radiance_problem's inputs as a `mode` request: "flux" (onlyfl),
    "radiance" (umu and phi) or "all_modes" (onlyfl=False, no angles)."""
    args, kws = radiance_problem(nstr, nlyr, nbc, **kw)
    if mode == "flux":
        kws.update(onlyfl=True, umu=None, phi=None)
    elif mode == "all_modes":
        kws.update(umu=None, phi=None)
    return args, kws


def ref_solve(args, kw, dtype, eig_method="auto", bvp_method="auto"):
    """The reference's solve_rte on the same inputs under one jax.jit
    (host angles, flags and the BRDF model stay static)."""
    static = {k: v for k, v in kw.items()
              if k in ("umu", "phi") or not isinstance(v, np.ndarray)}
    dyn = {k: jnp.asarray(v, dtype) for k, v in kw.items()
           if k not in static}
    fn = jax.jit(lambda a, d: ref_solve_rte(
        *a, dtype=dtype, eig_method=eig_method, bvp_method=bvp_method,
        **static, **d))
    return fn(tuple(jnp.asarray(x, dtype) for x in args), dyn)


def worst(got, ref) -> dict:
    """max |port - reference| / max |reference| per field (uu None on
    both sides for requests without user angles)."""
    out = {}
    for name in FIELDS:
        a, b = getattr(got, name), getattr(ref, name)
        if b is None:
            assert a is None, name
            continue
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        assert np.isfinite(a).all(), name
        out[name] = float(np.abs(a - b).max()) / max(
            float(np.abs(b).max()), 1e-300)
    return out


CASES = {
    "nstr2_flux": dict(nstr=2),
    "nstr6_flux_thermal": dict(nstr=6, planck=True),
    "nstr10_radiance": dict(nstr=10, nlyr=3, mode="radiance"),
    "nstr6_radiance_hapke_thermal": dict(nstr=6, mode="radiance",
                                         brdf="hapke", planck=True),
    "nstr10_radiance_rpv_no_beam": dict(nstr=10, nlyr=3, mode="radiance",
                                        brdf="rpv", beam=False),
    "nstr20_flux": dict(nstr=20, nlyr=3),
    "nstr8_flux_hapke": dict(nstr=8, brdf="hapke"),
    "nstr4_all_modes_thermal": dict(nstr=4, mode="all_modes", planck=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_generic_f64_matches_reference(case):
    args, kw = generic_problem(**CASES[case])
    got = port(args, kw, torch.float64)
    errs = worst(got, ref_solve(args, kw, jnp.float64))
    assert max(errs.values()) <= 1e-9, errs


def _pipeline_pair(**cfg):
    ref = ref_run_pipeline(RefConfig(**cfg).validate())
    got = run_pipeline(Config(**cfg).validate(), dtype=torch.float64,
                       device="cpu")
    return ref, got


@pytest.mark.parametrize("iout", [10, 20])
def test_pipeline_nstr6_matches_reference(iout):
    """run_pipeline at nstr=6 (N odd: the generic path) through solar and
    thermal samples, fluxes (iout=10) and radiances at 2 zeniths x 2
    azimuths (iout=20), against the reference's float64 pipeline."""
    ref, got = _pipeline_pair(idatm=2, wlinf=1.9, wlsup=2.1, wlinc=0.05,
                              sza=30.0, albcon=0.2, nstr=6, iout=iout,
                              nzen=2, uzen=[0.0, 120.0, 0, 0, 0], nphi=2,
                              phi=[0.0, 90.0, 0, 0, 0])
    names = ("fdir", "fdn", "fup", "dfdt", "uavg")
    if iout == 20:
        names += ("uu",)
    else:
        assert got.uu is None and ref.uu is None
    for name in names:
        a, b = getattr(got, name), np.asarray(getattr(ref, name))
        assert a.shape == b.shape and np.isfinite(a).all(), name
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err < 1e-7, (name, err)


def test_full_scatter_matrix_matches_reference():
    """sources.full_scatter_matrix, the 2N x 2N operator [[A, B], [B, A]]
    beam_particular splits by symmetry, against the reference's."""
    from sbdart_tpu.solver.sources import full_scatter_matrix as ref_full
    from sbdart_tpu_torch.solver.sources import full_scatter_matrix

    rng = np.random.default_rng(3)
    cpp, cpm = rng.normal(size=(2, 2, 4, 3, 3))
    w = rng.uniform(0.1, 0.5, size=3)
    got = full_scatter_matrix(torch.tensor(cpp), torch.tensor(cpm),
                              torch.tensor(w))
    ref = ref_full(jnp.asarray(cpp), jnp.asarray(cpm), jnp.asarray(w))
    assert got.shape == (2, 4, 6, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
