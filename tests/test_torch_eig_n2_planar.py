"""B8 (the n = 2 eigen chain + beam solve on prebuilt scattering matrices):
the port's plain torch version against the JAX package's Pallas kernel
(_eig_beam_call_layered_n2, the entry of _n2_planar_kernel) run through
the interpreter, on the same float32 operands, under the bars of
tests/test_torch_eig_n2.py:

  * kk away from the conservative dither at the reference's interpret bar,
    rtol 1e-5 / atol 1e-6;
  * every plane no further from a float64 evaluation of the same algorithm
    (same float32 constants) than twice the reference's distance.

Operands are those of the radiance path at nstr=4: the all-mode C^pp /
C^pm (modes 0-3) of random optics with conservative (1 - dither) and
near-conservative (0.99999) columns, the beam right-hand side r1/r2 and
one beam cosine per lane (0.5 where there is no beam), on the flat
(mode, layer, column) lane axis, 130 lanes a mode.
"""

import jax.numpy as jnp
import numpy as np
import torch

from launch_counts import launches

from sbdart_tpu.pallas.eig import _eig_beam_call_layered_n2
from sbdart_tpu_torch.kernels import eig_n2
from sbdart_tpu_torch.kernels.eig_beam import (
    eig_beam_chain_lane,
    eig_beam_chain_plain,
)
from sbdart_tpu_torch.kernels.eig_n2 import (
    eig_beam_chain_n2,
    eig_beam_chain_n2_plain,
)
from sbdart_tpu_torch.solver.deltam import ssalb_dither
from sbdart_tpu_torch.solver.eig import angular_tables
from sbdart_tpu_torch.solver.sources import _ylm_at

NAMES = ("kk", "gp", "gm", "zp", "zm")
TAB = angular_tables(4, 4)


def planar_problem(b, seed=0):
    """(cppl, cpml [1, 2, 2, 4b], r1, r2 [1, 2, 4b], mu0 [1, 4b]) float32,
    and the conservative-lane mask [4b]."""
    rng = np.random.default_rng(seed)
    ssalb = rng.uniform(0.05, 0.999, b)
    ssalb[::17] = 1.0 - ssalb_dither(torch.float32)
    ssalb[5::19] = 0.99999
    g = rng.uniform(0.0, 0.85, b)
    c = 0.5 * ssalb[:, None] * (2 * np.arange(4) + 1) * g[:, None] \
        ** np.arange(4)                                 # [b, l]
    ylm, par = TAB.ylm, TAB.parity                      # [m, l, i], [m, l]
    cpp = np.einsum("mli,mlj,bl->ijmb", ylm, ylm, c)
    cpm = np.einsum("ml,mli,mlj,bl->ijmb", par, ylm, ylm, c)
    beam = rng.uniform(size=b) < 0.8
    mu0 = np.where(beam, rng.uniform(0.2, 1.0, b), 0.5)
    y0d = _ylm_at(torch.from_numpy(mu0), 4, 4).numpy() * par   # [b, m, l]
    scale = np.where(beam, 1.0 / (2.0 * np.pi), 0.0)
    mfac = np.where(np.arange(4) == 0, 1.0, 2.0)
    x0p = np.einsum("mli,bl,bml->imb", ylm, c, y0d) * mfac[None, :, None] \
        * scale
    x0m = np.einsum("ml,mli,bl,bml->imb", par, ylm, c, y0d) \
        * mfac[None, :, None] * scale
    r1 = (x0p + x0m) / TAB.mu[:, None, None]
    r2 = (x0p - x0m) / TAB.mu[:, None, None]
    ops = (cpp.reshape(1, 2, 2, -1), cpm.reshape(1, 2, 2, -1),
           r1.reshape(1, 2, -1), r2.reshape(1, 2, -1),
           np.broadcast_to(mu0, (4, b)).reshape(1, -1))
    conservative = np.zeros(b, bool)
    conservative[::17] = conservative[5::19] = True
    return [np.ascontiguousarray(x, np.float32) for x in ops], \
        np.tile(conservative, 4)


def _both():
    ops, cons = planar_problem(130)
    ref = _eig_beam_call_layered_n2(
        *(jnp.asarray(x) for x in ops),
        mu_t=tuple(float(x) for x in TAB.mu),
        w_t=tuple(float(x) for x in TAB.w), interpret=True)
    got = eig_beam_chain_n2_plain(*(torch.from_numpy(x) for x in ops), TAB)
    ref = [np.asarray(r) for r in ref]
    got = [g.numpy() for g in got]
    for name, r, g in zip(NAMES, ref, got):
        assert g.shape == r.shape and g.dtype == np.float32, name
        assert np.isfinite(g).all(), name
    return ops, cons, ref, got


def test_eig_n2_planar_plain_matches_pallas_interpret():
    _, cons, ref, got = _both()
    np.testing.assert_allclose(got[0][..., ~cons], ref[0][..., ~cons],
                               rtol=1e-5, atol=1e-6, err_msg="kk")


def test_eig_n2_planar_plain_at_reference_f32_floor():
    ops, _, ref, got = _both()
    truth = eig_n2._stack(1, ops[0].shape[-1], eig_n2._n2_chain(
        eig_n2._consts(TAB, torch.float32),
        *_entries([torch.from_numpy(x).double() for x in ops])))
    for name, r, g, t in zip(NAMES, ref, got, truth):
        t = t.numpy()
        scale = np.abs(t).max()
        err_ref = np.abs(r - t).max() / scale
        err_got = np.abs(g - t).max() / scale
        assert err_got <= 2.0 * err_ref + 1e-7, (name, err_got, err_ref)


def _entries(ops):
    cppl, cpml, r1, r2, mu0 = ops
    ij = ((0, 0), (0, 1), (1, 0), (1, 1))
    return ([cppl[:, i, j] for i, j in ij], [cpml[:, i, j] for i, j in ij],
            r1[:, 0], r1[:, 1], r2[:, 0], r2[:, 1], mu0)


def test_flat_entry_is_a_one_layer_view():
    """eig_beam_chain_lane: B8 at N = 2 and B4 at N >= 4 on [1, ...] views
    of the flat lane operands, the plain versions on the CPU."""
    ops, _ = planar_problem(20, seed=2)
    ops = [torch.from_numpy(x) for x in ops]
    flat = eig_beam_chain_lane(*(x[0] for x in ops[:4]), ops[4], TAB)
    for f, w in zip(flat, eig_beam_chain_n2_plain(*ops, TAB)):
        assert torch.equal(f, w[0])
    rng = np.random.default_rng(4)
    tab8 = angular_tables(8, 1)
    a = rng.normal(size=(4, 4, 33)) * 0.05
    cpp = torch.from_numpy(a + a.transpose(1, 0, 2))
    r = torch.from_numpy(rng.normal(size=(4, 33)))
    mu0 = torch.from_numpy(rng.uniform(0.2, 1.0, (1, 33)))
    flat = eig_beam_chain_lane(cpp, 0.5 * cpp, r, r, mu0, tab8)
    want = eig_beam_chain_plain(cpp[None], 0.5 * cpp[None], r[None],
                                r[None], mu0, tab8.mu, tab8.w, sweeps=6)
    for f, w in zip(flat, want):
        assert torch.equal(f, w[0])


def test_eig_n2_planar_wrapper_takes_plain_version_on_cpu():
    ops = [torch.from_numpy(x) for x in planar_problem(9, seed=1)[0]]
    before = launches(eig_beam_chain_n2)
    for g, w in zip(eig_beam_chain_n2(*ops, TAB),
                    eig_beam_chain_n2_plain(*ops, TAB)):
        assert torch.equal(g, w)
    assert launches(eig_beam_chain_n2) == before
