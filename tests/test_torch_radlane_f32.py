"""The radiance slice as a whole in float32: the port's solve_rte(onlyfl=
False) through its kernel wrappers (which run their plain versions on CPU
tensors) against the JAX package's lane radiance path with its Pallas
kernels in interpret mode (eig_method="fused_interpret"), under
tests/test_radlane.py's bar: 5e-4 of each field's max, on uu and all five
flux fields.  The cases of tests/test_torch_radlane.py except the
52-layer one, which runs in float64 only.
"""

import jax.numpy as jnp
import pytest
import torch
from test_torch_radlane import CASES, port, radiance_problem, reference, worst

F32_CASES = [c for c in CASES if c != "nstr4_52_layers"]


@pytest.mark.parametrize("case", F32_CASES)
def test_radlane_f32_matches_reference_lane(case):
    args, kw = radiance_problem(**CASES[case])
    ref = reference(args, kw, jnp.float32, "fused_interpret")
    got = port(args, kw, torch.float32)
    assert got.uu.dtype == torch.float32
    errs = worst(got, ref)
    assert max(errs.values()) <= 5e-4, errs
