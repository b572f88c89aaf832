"""The radiance slice as a whole: the port's solve_rte(onlyfl=False)
(solver/radlane.py) against the JAX package's, in float64.

The port's float64 route runs the plain versions of its kernels (6 Jacobi
sweeps at N >= 4); the reference's float64 route on the CPU is its
generic path (eig_method="auto": compute_radiances over eigh and the
batch-major BVP).  Bar: 1e-9 of each field's max, on uu and all five flux
fields (measured ~4e-15 at most).  tests/test_torch_radlane_f32.py holds
the float32 route against the reference's lane path in interpret mode.

Inputs: the distributions of tests/test_radlane.py:21-46 from a seeded
numpy generator, at small sizes (4-5 layers, 2-3 columns, U = 4 view
cosines of both signs, P = 3 azimuths, phi0 = 10, fisot = 0.2).  Cases:
nstr 4 and 16 solar; nstr 8 with the thermal source; nstr 8 on a Hapke
BRDF; corint off; upward-only cosines; no beam (fisot > 0 keeps it
nontrivial); nstr 12 on an RPV surface with the thermal source; and nstr
4 at 52 layers, where the reference's n = 2 BVP leaves its planar kernel
for _rt_kernel (B5 at N = 2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbdart_tpu.solver.disort import solve_rte as ref_solve_rte
from sbdart_tpu_torch.convert import brdf_to_torch
from sbdart_tpu_torch.solver.disort import solve_rte

FIELDS = ("rfldir", "rfldn", "flup", "dfdt", "uavg", "uu")
UMU = (0.35, 0.95, -0.5, -0.9)
PHI = (0.0, 120.0, 240.0)

CASES = {
    "nstr4": dict(nstr=4),
    "nstr16": dict(nstr=16),
    "nstr8_thermal": dict(nstr=8, planck=True),
    "nstr8_hapke": dict(nstr=8, nlyr=4, nbc=2, brdf="hapke"),
    "nstr12_rpv_thermal": dict(nstr=12, nlyr=4, nbc=2, brdf="rpv",
                               planck=True),
    "corint_off": dict(nstr=16, nlyr=4, nbc=2, corint=False),
    "upward_only": dict(nstr=4, nlyr=4, nbc=2, umu=(0.4, 0.8)),
    "no_beam": dict(nstr=8, beam=False),
    "nstr4_52_layers": dict(nstr=4, nlyr=52, nbc=2),
}


def radiance_problem(nstr, nlyr=5, nbc=3, *, planck=False, beam=True,
                     brdf=None, corint=True, umu=UMU, seed=1):
    """(dtau, ssalb, pmom) and solve_rte's keywords as float64 numpy
    (tests/test_radlane.py:21-46); `brdf` "hapke" asks for DISORT's default
    Hapke surface, "rpv" for an RPV surface (the reference's models)."""
    rng = np.random.default_rng(seed)
    dtau = rng.uniform(0.001, 0.6, (nbc, nlyr))
    ssalb = rng.uniform(0.05, 0.999, (nbc, nlyr))
    g = rng.uniform(0.0, 0.85, (nbc, nlyr))
    pmom = g[..., None] ** np.arange(nstr + 1)
    fbeam = np.where(rng.uniform(size=nbc) < 0.8, 1.0, 0.0) * float(beam)
    kw = dict(nstr=nstr, fbeam=fbeam, umu0=rng.uniform(0.2, 1.0, (nbc,)),
              albedo=rng.uniform(0.0, 0.8, (nbc,)), onlyfl=False,
              umu=np.array(umu), phi=np.array(PHI), phi0=10.0, fisot=0.2,
              corint=corint)
    if planck:
        kw.update(planck=True, temper=np.linspace(250, 290, nlyr + 1)[None]
                  .repeat(nbc, 0), wvnlo=800.0, wvnhi=900.0, btemp=290.0,
                  temis=0.1, ttemp=210.0)
    if brdf == "hapke":
        from sbdart_tpu.solver.brdf import HapkeBrdf

        kw["brdf"] = HapkeBrdf(b0=1.0, hh=0.06, w=0.6)
    elif brdf == "rpv":
        from sbdart_tpu.solver.brdf import RpvBrdf

        kw["brdf"] = RpvBrdf(rho0=0.12, k=0.8, theta=-0.15)
    return (dtau, ssalb, pmom), kw


def reference(args, kw, dtype, eig_method):
    """The reference's solve_rte on the same inputs (host angles stay
    numpy)."""
    def j(x):
        return jnp.asarray(x, dtype) if isinstance(x, np.ndarray) else x

    return ref_solve_rte(
        *(j(a) for a in args), dtype=dtype, eig_method=eig_method,
        **{k: v if k in ("umu", "phi") else j(v) for k, v in kw.items()})


def port(args, kw, dtype):
    """The port's solve_rte on the CPU, the BRDF carried across."""
    kw = dict(kw)
    if "brdf" in kw:
        kw["brdf"] = brdf_to_torch(kw["brdf"], device="cpu", dtype=dtype)
    return solve_rte(*args, dtype=dtype, device="cpu", **kw)


def worst(got, ref) -> dict:
    """max |port - reference| / max |reference|, per field."""
    out = {}
    for name in FIELDS:
        a = getattr(got, name).numpy()
        b = np.asarray(getattr(ref, name))
        assert a.shape == b.shape, (name, a.shape, b.shape)
        assert np.isfinite(a).all(), name
        out[name] = float(np.abs(a - b).max()) / max(
            float(np.abs(b).max()), 1e-300)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_radlane_f64_matches_reference_generic(case):
    args, kw = radiance_problem(**CASES[case])
    ref = reference(args, kw, jnp.float64, "auto")
    got = port(args, kw, torch.float64)
    assert got.uu.dtype == torch.float64
    errs = worst(got, ref)
    assert max(errs.values()) <= 1e-9, errs


def test_radlane_refuses_zero_cosine():
    args, kw = radiance_problem(4, 3, 2)
    kw["umu"] = np.array([0.5, 0.0])
    with pytest.raises(ValueError, match="nonzero"):
        port(args, kw, torch.float64)
