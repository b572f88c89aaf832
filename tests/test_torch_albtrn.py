"""The slab albedo / transmission mode (ibcnd=1) of the port against the
reference's (sbdart_tpu/solver/albtrn.py, pipeline.py:run_albtrn), float64
on the CPU, and the closed-form checks of tests/test_albtrn.py on the
port.

The reference's slab solve runs under one jax.jit; the bar is 1e-9 of
each field's max (float64), 5e-4 for float32 (the end-to-end bar of the
kernel path on the card).  The conservative slab (w0 = 1) is the
exception: its eigenproblem is singular but for the dither of w0 to
1 - 1e-9 (constants.SSALB_DITHER), which amplifies rounding by about
1/dither, so two correct float64 evaluations part there by up to
eps/dither = 2.2e-7 of the max (the reference's own jit and eager runs
part by 2.7e-9, the port from either by 2.7e-8).  That case is held at
eps/dither, and its closure a + t = 1 at no more than twice the
reference's distance from 1.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbdart_tpu.config import Config as RefConfig
from sbdart_tpu.pipeline import run_albtrn as ref_run_albtrn
from sbdart_tpu.solver.albtrn import slab_albedo_transmission as ref_slab
from sbdart_tpu_torch.config import Config
from sbdart_tpu_torch.constants import SSALB_DITHER
from sbdart_tpu_torch.pipeline import run_albtrn
from sbdart_tpu_torch.solver.albtrn import slab_albedo_transmission


def hg_moments(g, nmom):
    return np.array([g**l for l in range(nmom)])


def random_slab(nstr, seed):
    """Three spectral samples x 5 layers of HG optics."""
    rng = np.random.default_rng(seed)
    dtau = rng.uniform(0.01, 2.0, (3, 5))
    ssalb = rng.uniform(0.3, 0.999, (3, 5))
    g = rng.uniform(0.0, 0.8, (3, 5))
    return dtau, ssalb, g[..., None] ** np.arange(nstr + 1)


# (nstr, dtau, ssalb, pmom, umu, albedo): random slabs at each lane nstr,
# then the reference's three cases (tests/test_albtrn.py)
CASES = {
    f"random_nstr{n}": (n, *random_slab(n, n), np.array([0.2, 0.5, 0.9]),
                        0.1)
    for n in (4, 8, 16)
}
CASES.update({
    "conservative": (16, np.array([1.0, 2.0]), np.ones(2),
                     np.tile(hg_moments(0.6, 34), (2, 1)),
                     np.array([0.2, 0.5, 0.9]), 0.0),
    "absorbing": (16, np.array([3.0]), np.array([0.9]),
                  np.tile(hg_moments(0.7, 34), (1, 1)), np.array([0.4, 0.8]),
                  0.0),
    "thin": (8, np.array([1e-5]), np.array([0.9]),
             np.tile(hg_moments(0.5, 10), (1, 1)), np.array([0.5]), 0.0),
})


def port_slab(case, dtype=torch.float64):
    nstr, dtau, ssalb, pmom, umu, albedo = case
    a, t = slab_albedo_transmission(dtau, ssalb, pmom, nstr=nstr, umu=umu,
                                    albedo=albedo, dtype=dtype, device="cpu")
    return a.numpy(), t.numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_slab_matches_reference(name):
    nstr, dtau, ssalb, pmom, umu, albedo = CASES[name]
    fn = jax.jit(functools.partial(ref_slab, nstr=nstr, dtype=jnp.float64))
    want = [np.asarray(w) for w in fn(dtau, ssalb, pmom, umu=umu,
                                      albedo=albedo)]
    got = port_slab(CASES[name])
    bar = np.finfo(np.float64).eps / SSALB_DITHER if name == "conservative" \
        else 1e-9
    for g, w in zip(got, want):
        assert g.shape == w.shape == dtau.shape[:-1] + umu.shape
        assert np.isfinite(g).all()
        assert np.abs(g - w).max() <= bar * np.abs(w).max()
    if name == "conservative":
        assert np.all(np.abs(sum(got) - 1) <= 2 * np.abs(sum(want) - 1))


def test_closed_forms():
    """w0 = 1 over a black surface: albedo + transmission = 1 per angle,
    oblique incidence reflects more; absorbing slab: both in (0, 1) with
    a + t < 1; tau -> 0: transmission -> 1, albedo -> 0."""
    a, t = port_slab(CASES["conservative"])
    np.testing.assert_allclose(a + t, 1.0, rtol=3e-6)
    assert a[0] > a[2]
    a, t = port_slab(CASES["absorbing"])
    assert np.all(a > 0) and np.all(t > 0) and np.all(a + t < 1.0)
    a, t = port_slab(CASES["thin"])
    np.testing.assert_allclose(t[0], 1.0, atol=1e-4)
    assert a[0] < 1e-4


ALBTRN = dict(idatm=2, wlinf=0.5, wlsup=0.6, wlinc=0.05, nstr=4, ibcnd=1,
              nzen=3, uzen=[0.0, 45.0, 75.0, 0.0, 0.0], albcon=0.1)


@functools.lru_cache(maxsize=1)
def ref_albtrn_f32():
    return ref_run_albtrn(RefConfig(**ALBTRN).validate(), dtype=jnp.float32)


@pytest.mark.parametrize("eig_method", ["auto", "plain"])
def test_run_albtrn_float32_matches_reference(eig_method):
    """float32 on the CPU, through the kernels' plain versions ("auto" on
    CPU tensors) and the plain route, against the reference's float32."""
    want = ref_albtrn_f32()
    got = run_albtrn(Config(**ALBTRN).validate(), dtype=torch.float32,
                     device="cpu", eig_method=eig_method)
    for field in ("albmed", "trnmed"):
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        assert g.dtype == np.float32 and g.shape == w.shape == (3, 3)
        assert np.abs(g - w).max() <= 5e-4 * np.abs(w).max(), field
