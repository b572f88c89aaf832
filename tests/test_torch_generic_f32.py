"""The generic solver path in float32: the port's solve_rte (its kernel
route, the wrappers taking their plain versions on CPU tensors) against
the JAX package's TPU route run through the Pallas interpreter.

The reference is driven onto its TPU route explicitly: bvp_method
"kernel_interpret" (block_thomas_rt: B2, B5 or B6 at the shape) and the
eigen route it takes on the TPU -- "pallas_interpret" (B9) for all-mode
solves with N even and <= 8, "fused_interpret" (B4) for flux-only BRDF
solves, "lane" for odd N and N > 8.  Bar: 5e-4 of each field's max, the
reference's own float32 bar (tests/test_pallas_kernels.py:364-368);
measured <= 1.1e-5.  At nstr=40 (SBDART's stream limit) the port's float32
fluxes are also held to be no further from the float64 route than the
reference's are.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_generic import generic_problem, ref_solve, worst
from test_torch_radlane import port

CASES = {   # name: (problem, the reference's TPU eigen route)
    "nstr2_flux": (dict(nstr=2, nbc=3), "lane"),
    "nstr6_flux_thermal": (dict(nstr=6, nbc=3, planck=True), "lane"),
    "nstr14_flux": (dict(nstr=14, nlyr=3, nbc=3), "lane"),
    "nstr20_flux": (dict(nstr=20, nlyr=3, nbc=3), "lane"),
    "nstr40_flux": (dict(nstr=40, nlyr=3, nbc=3), "lane"),
    "nstr10_radiance": (dict(nstr=10, nlyr=3, nbc=3, mode="radiance"),
                        "lane"),
    "nstr6_radiance_rpv_thermal": (dict(nstr=6, nbc=3, mode="radiance",
                                        brdf="rpv", planck=True), "lane"),
    "nstr8_flux_hapke": (dict(nstr=8, nbc=3, brdf="hapke"),
                         "fused_interpret"),
    "nstr4_all_modes": (dict(nstr=4, nbc=3, mode="all_modes"),
                        "pallas_interpret"),
    "nstr8_all_modes_thermal": (dict(nstr=8, nbc=3, mode="all_modes",
                                     planck=True), "pallas_interpret"),
}


@functools.cache
def _reference(case):
    """The reference's float32 TPU route on a case's inputs (one jit
    compile a case, shared by the tests of this file)."""
    problem, eig_method = CASES[case]
    args, kw = generic_problem(**problem)
    return ref_solve(args, kw, jnp.float32, eig_method, "kernel_interpret")


@pytest.mark.parametrize("case", list(CASES))
def test_generic_f32_matches_reference_tpu_route(case):
    problem, _ = CASES[case]
    args, kw = generic_problem(**problem)
    got = port(args, kw, torch.float32)
    errs = worst(got, _reference(case))
    assert max(errs.values()) <= 5e-4, errs


def test_generic_f32_nstr40_no_further_from_f64_than_reference():
    """At nstr=40 each flux field of the port's float32 route lies within
    twice the reference float32 route's distance of the float64 route (of
    the field's max): the port adds no float32 error of its own there."""
    problem, _ = CASES["nstr40_flux"]
    args, kw = generic_problem(**problem)
    f64 = port(args, kw, torch.float64)
    got = port(args, kw, torch.float32)
    ref = _reference("nstr40_flux")
    for name in ("rfldir", "rfldn", "flup", "dfdt", "uavg"):
        want = getattr(f64, name).numpy()
        scale = np.abs(want).max()
        port_err = np.abs(getattr(got, name).numpy() - want).max() / scale
        ref_err = np.abs(np.asarray(getattr(ref, name)) - want).max() / scale
        assert port_err <= 2.0 * ref_err + 1e-7, (name, port_err, ref_err)


@pytest.mark.parametrize("case", ["nstr4_all_modes", "nstr6_flux_thermal"])
def test_generic_f32_scan_route_runs_b10(case, monkeypatch):
    """bvp_method="scan": the assembled blocks go through B10's wrapper
    (its plain version on CPU tensors), against the reference's scan
    route at the same eigen route, within the same bar."""
    import sbdart_tpu_torch.kernels.blocktri as bt

    calls = []
    wrapper = bt.block_thomas
    monkeypatch.setattr(bt, "block_thomas",
                        lambda *a: calls.append(a[0].shape) or wrapper(*a))
    problem, eig_method = CASES[case]
    args, kw = generic_problem(**problem)
    got = port(args, dict(kw, bvp_method="scan"), torch.float32)
    ref = ref_solve(args, kw, jnp.float32, eig_method, "scan")
    assert len(calls) == 1
    errs = worst(got, ref)
    assert max(errs.values()) <= 5e-4, errs
