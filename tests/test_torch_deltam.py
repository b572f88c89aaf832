"""Delta-M scaling: the port's apply_deltam against the JAX package's, in
float64 at rtol 1e-12 (same formulas, same dither rule; the only
difference is the framework's elementwise rounding)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbdart_tpu.solver.deltam import apply_deltam as ref_apply_deltam
from sbdart_tpu_torch.solver.deltam import apply_deltam, ssalb_dither

FIELDS = ("dtau", "ssalb", "gl", "f", "dtau_unscaled")


def _inputs(nmom, seed=4):
    rng = np.random.default_rng(seed)
    dtau = rng.uniform(0.0, 2.0, (7, 9))
    ssalb = rng.uniform(0.0, 1.0, (7, 9))
    ssalb[:, 0] = 1.0                     # conservative: dithered
    ssalb[:, 1] = 0.0
    g = rng.uniform(-0.2, 0.95, (7, 9))
    pmom = g[..., None] ** np.arange(nmom)
    return dtau, ssalb, pmom


@pytest.mark.parametrize("deltam,nmom", [(True, 5), (False, 5), (True, 4),
                                         (True, 17)])
def test_apply_deltam_matches_reference_f64(deltam, nmom):
    dtau, ssalb, pmom = _inputs(nmom)
    ref = ref_apply_deltam(jnp.asarray(dtau), jnp.asarray(ssalb),
                           jnp.asarray(pmom), 4, deltam)
    got = apply_deltam(torch.from_numpy(dtau), torch.from_numpy(ssalb),
                       torch.from_numpy(pmom), 4, deltam)
    for name, r, g in zip(FIELDS, ref, got):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12,
                                   atol=0.0, err_msg=name)
    # ssalb = 1 is held off the singular point by the f64 dither
    assert got.ssalb[:, 0].max() <= 1.0 - 1e-9


def test_dither_rule_follows_dtype():
    """max(SSALB_DITHER, 100 eps(dtype)) (sbdart_tpu/solver/deltam.py:51)."""
    assert ssalb_dither(torch.float64) == 1e-9
    assert ssalb_dither(torch.float32) == pytest.approx(
        100.0 * float(np.finfo(np.float32).eps))
