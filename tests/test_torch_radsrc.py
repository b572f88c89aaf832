"""B7 (the radiance source projections and path integrals): the port's
plain torch version against the JAX package's Pallas kernel run through
the interpreter, on the same float32 operands.

Operands: the ones the radiance path hands B7, captured from the port's
float32 solve of tests/test_torch_radlane.py's problem (seeded numpy
optics, 5 layers, user cosines of both signs) at N = 2, 4 and 8.  One lane
of mode 1 is then put on the resonance of the 'away' integral at each
user cosine, kk = (1 +- 1e-6) / |u|, where both versions take the Taylor
branch.

Bar: the two float32 routes round differently (the reference divides by
a Python-number cosine, which XLA turns into a multiply by its float32
reciprocal, and XLA's CPU backend contracts multiply-adds into FMAs; the
port multiplies by |u| and rounds every product), and the sums of up to
nstr products that build sd/su cancel, so the reference's interpret bar
(rtol 1e-5 / atol 1e-6) is out of reach for both: at N = 8 the
reference itself is 2e-4 of the output's max from a float64 evaluation.
So each mode's output plane j[m] of the port is held no further from a
float64 evaluation of the same algorithm on the same operands than twice
the reference's distance, plus 1e-6 of the plane's max (measured: ratio
at most 2.17, excess at most 1.1e-8, at N = 8).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_radlane import port, radiance_problem

import sbdart_tpu_torch.solver.radlane as radlane
from sbdart_tpu.pallas.radsrc import rad_source_lane as ref_rad_source_lane
from sbdart_tpu_torch.kernels.radsrc import (
    rad_source_lane,
    rad_source_lane_plain,
)


def captured_operands(nstr, nbc, umu=(0.35, 0.95, -0.5, -0.9), seed=1,
                      monkeypatch=None):
    """B7's float32 operands from the port's radiance solve, with mode 1
    put on the resonance at lane u_i for each cosine u_i."""
    seen = {}

    def spy(*args):
        seen["args"] = args
        return rad_source_lane_plain(*args)

    monkeypatch.setattr(radlane, "rad_source_lane", spy)
    args, kw = radiance_problem(nstr, 5, nbc, umu=umu, seed=seed)
    port(args, kw, torch.float32)
    *ops, umu_used = seen["args"]
    ops = [o.contiguous().clone() for o in ops]
    kk = ops[7]
    for u_i, u in enumerate(umu_used):
        kk[1, 0, u_i] = (1.0 + (1e-6 if u_i % 2 else -1e-6)) / abs(u)
    return ops, umu_used


def _distances(ops, umu):
    ref = np.asarray(ref_rad_source_lane(*(jnp.asarray(x.numpy()) for x in ops),
                                         umu, interpret=True))
    got = rad_source_lane_plain(*ops, umu).numpy()
    truth = rad_source_lane_plain(*(x.double() for x in ops), umu).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    scale = np.abs(truth).max(axis=(1, 2))

    def dist(x):
        return np.abs(x - truth).max(axis=(1, 2)) / scale

    return dist(ref), dist(got)


@pytest.mark.parametrize("nstr,nbc", [(4, 26), (8, 7), (16, 4)])
def test_radsrc_plain_at_reference_f32_floor(monkeypatch, nstr, nbc):
    ops, umu = captured_operands(nstr, nbc, monkeypatch=monkeypatch)
    err_ref, err_got = _distances(ops, umu)
    assert (err_got <= 2.0 * err_ref + 1e-6).all(), (err_got, err_ref)


def test_radsrc_upward_only_angles(monkeypatch):
    ops, umu = captured_operands(8, 7, umu=(0.2, 0.7), seed=2,
                                 monkeypatch=monkeypatch)
    err_ref, err_got = _distances(ops, umu)
    assert (err_got <= 2.0 * err_ref + 1e-6).all(), (err_got, err_ref)


def test_radsrc_resonance_lanes_take_the_taylor_branch(monkeypatch):
    """On the resonance lanes the 'away' integral's closed form divides by
    u k - 1 ~ 1e-6; with the Taylor form the float32 result stays within
    1e-5 of the float64 evaluation of the same operands."""
    ops, umu = captured_operands(4, 26, monkeypatch=monkeypatch)
    got = rad_source_lane_plain(*ops, umu)
    truth = rad_source_lane_plain(*(x.double() for x in ops), umu)
    lanes = list(range(len(umu)))
    err = (got.double() - truth).abs()[1][:, lanes].max()
    assert float(err) <= 1e-5 * float(truth[1].abs().max())


def test_radsrc_wrapper_takes_plain_version_on_cpu(monkeypatch):
    ops, umu = captured_operands(8, 3, monkeypatch=monkeypatch)
    before = rad_source_lane.launches
    assert torch.equal(rad_source_lane(*ops, umu),
                       rad_source_lane_plain(*ops, umu))
    assert rad_source_lane.launches == before


def test_radsrc_refuses_zero_cosine(monkeypatch):
    ops, _ = captured_operands(4, 2, monkeypatch=monkeypatch)
    with pytest.raises(ValueError, match="nonzero"):
        rad_source_lane_plain(*ops, np.array([0.5, 0.0, -0.5, 0.2]))
