"""The port's band-integrated Planck function against the JAX package's.

Same NumPy inputs on both sides, across both series branches of the
cumulative fraction (x = c2 nu / T below and above the switch at 1).

  * float64: relative error <= 1e-12 (the two evaluate the same series
    with the same coefficients; only the order of a few roundings may
    differ), for planck_total (sigma T^4 / pi) too, over 1e-6-1e4 K;
  * float32, the flux path's precision: port and reference within 1e-6
    of the largest band value of each other (measured 1.9e-7 at 190 K,
    3.6e-7 at 290 K), and the port no further from the float64 value than
    the reference, normwise and per band (a narrow band takes the
    difference of two cumulative fractions near 1, so its float32
    relative error reaches ~5e-5 on both routes alike).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbdart_tpu.solver.planck import _cum_fraction as ref_cum_fraction
from sbdart_tpu.solver.planck import planck_band as ref_planck_band
from sbdart_tpu.solver.planck import planck_total as ref_planck_total
from sbdart_tpu_torch.constants import C2_RADIATION
from sbdart_tpu_torch.kernels.planck import _cum_fraction, planck_band
from sbdart_tpu_torch.solver.planck import planck_total


def bands(seed=0, n=400):
    """Band edges over 10-3500 cm^-1 at 150-330 K, every 17th sample at the
    pipeline's solar-mask temperature of 1e-4 K: x spans both branches."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(10.0, 3000.0, n)
    hi = lo + rng.uniform(1.0, 500.0, n)
    t = rng.uniform(150.0, 330.0, n)
    t[::17] = 1e-4
    return lo, hi, t


def test_cum_fraction_both_branches_f64():
    x = np.concatenate([np.linspace(1e-4, 1.0, 200),
                        np.linspace(1.0, 60.0, 300)])
    ref = np.asarray(ref_cum_fraction(jnp.asarray(x), jnp.float64))
    got = _cum_fraction(torch.from_numpy(x)).numpy()
    assert (x < 1.0).any() and (x > 1.0).any()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-300)


def test_planck_band_f64_matches_reference():
    lo, hi, t = bands()
    x = C2_RADIATION * np.concatenate([lo, hi]) / np.tile(t, 2)
    assert (x < 1.0).any() and (x > 1.0).any()
    ref = np.asarray(ref_planck_band(jnp.asarray(lo), jnp.asarray(hi),
                                     jnp.asarray(t), jnp.float64))
    got = planck_band(torch.from_numpy(lo), torch.from_numpy(hi),
                      torch.from_numpy(t), torch.float64)
    assert got.dtype == torch.float64
    got = got.numpy()
    np.testing.assert_array_equal(got[::17], 0.0 * got[::17])
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-300)


@pytest.mark.parametrize("temp", [190.0, 290.0])
def test_planck_band_f32_matches_reference(temp):
    lo, hi, _ = bands(seed=1)
    t = np.full_like(lo, temp)
    truth = np.asarray(ref_planck_band(jnp.asarray(lo), jnp.asarray(hi),
                                       jnp.asarray(t), jnp.float64))
    ref = np.asarray(ref_planck_band(jnp.asarray(lo, jnp.float32),
                                     jnp.asarray(hi, jnp.float32),
                                     jnp.asarray(t, jnp.float32),
                                     jnp.float32))
    got = planck_band(torch.tensor(lo, dtype=torch.float32),
                      torch.tensor(hi, dtype=torch.float32),
                      torch.tensor(t, dtype=torch.float32), torch.float32)
    assert got.dtype == torch.float32
    got = got.numpy().astype(np.float64)
    scale = np.abs(truth).max()
    assert np.abs(got - ref).max() <= 1e-6 * scale
    err_got = np.abs(got - truth)
    err_ref = np.abs(ref - truth)
    assert err_got.max() <= 2.0 * err_ref.max() + 1e-7 * scale
    big = truth > 1e-3 * scale
    rel_got = (err_got[big] / truth[big]).max()
    rel_ref = (err_ref[big] / truth[big]).max()
    assert rel_got <= 2.0 * rel_ref + 1e-6, (rel_got, rel_ref)


def temperatures(shape, seed=2):
    """1e-6-1e4 K, log-uniform, so every decade is sampled."""
    rng = np.random.default_rng(seed)
    return 10.0 ** rng.uniform(-6.0, 4.0, shape)


@pytest.mark.parametrize("shape", [(), (50,), (6, 9)])
@pytest.mark.parametrize("given", ["tensor", "numpy"])
def test_planck_total_matches_reference_f64(monkeypatch, shape, given):
    """sigma T^4 / pi in float64, from a CPU tensor (its device) or from
    NumPy values under SBDART_TPU_DEVICE=cpu (the default device)."""
    t = temperatures(shape)
    if shape == ():
        t = float(t)
    ref = np.asarray(ref_planck_total(jnp.asarray(t)))
    if given == "tensor" and shape == (50,):
        # float32 in: widened to float64, as the reference widens it
        ref = np.asarray(ref_planck_total(jnp.asarray(t, jnp.float32)))
        got = planck_total(torch.tensor(t, dtype=torch.float32))
    elif given == "tensor":
        got = planck_total(torch.tensor(t, dtype=torch.float64))
    else:
        monkeypatch.setenv("SBDART_TPU_DEVICE", "cpu")
        got = planck_total(t)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    assert got.shape == ref.shape == np.shape(t)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=0.0)


def test_planck_total_without_a_card_raises_unless_cpu_asked(monkeypatch):
    """Plain values go to the default device: without a card and without
    SBDART_TPU_DEVICE=cpu that raises, as every entry point of the port."""
    monkeypatch.delenv("SBDART_TPU_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="SBDART_TPU_DEVICE=cpu"):
        planck_total(288.0)


@pytest.mark.parametrize("temp", [200.0, 288.0, 330.0])
def test_planck_band_over_the_whole_spectrum_closes_on_planck_total(temp):
    """planck_band(1e-3, 1e7 cm^-1, T) = planck_total(T) to rtol 3e-9, the
    reference's own bar (tests/test_foundations.py)."""
    t = torch.tensor(temp, dtype=torch.float64)
    whole, total = planck_band(1.0e-3, 1.0e7, t), planck_total(t)
    np.testing.assert_allclose(whole.item(), total.item(), rtol=3e-9)
