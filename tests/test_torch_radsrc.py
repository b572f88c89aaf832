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

The layout the radiance path hands B7 is held too: kk, gp, gm, zp and zm
arrive as views of the eigen chain's flat output (no copy), on which the
plain version computes what it computes on contiguous copies, and the
wrapper refuses an operand whose lane axis has another stride than 1
rather than copying it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from launch_counts import launches
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
    before = launches(rad_source_lane)
    assert torch.equal(rad_source_lane(*ops, umu),
                       rad_source_lane_plain(*ops, umu))
    assert launches(rad_source_lane) == before


def path_operands(nstr, nbc, monkeypatch):
    """B7's float32 operands exactly as the radiance path hands them (no
    copies), and the eigen chain's flat outputs they came from."""
    seen = {}
    eig = radlane.eig_beam_chain_lane

    def eig_spy(*args, **kw):
        seen["eig"] = eig(*args, **kw)
        return seen["eig"]

    def spy(*args):
        seen["args"] = args
        return rad_source_lane_plain(*args)

    monkeypatch.setattr(radlane, "eig_beam_chain_lane", eig_spy)
    monkeypatch.setattr(radlane, "rad_source_lane", spy)
    args, kw = radiance_problem(nstr, 5, nbc, seed=1)
    port(args, kw, torch.float32)
    *ops, umu = seen["args"]
    return ops, umu, seen["eig"]


@pytest.mark.parametrize("nstr", [4, 8, 16])
def test_radsrc_operands_arrive_as_views_of_the_eigen_output(monkeypatch,
                                                             nstr):
    """kk, gp, gm, zp and zm reach B7 as views of the eigen chain's flat
    output (the same storage: no copy), lane stride 1; the tables
    contiguous."""
    ops, _, eig_out = path_operands(nstr, 3, monkeypatch)
    for name, got, flat in zip(("kk", "gp", "gm", "zp", "zm"),
                               (ops[7], ops[5], ops[6], ops[8], ops[9]),
                               eig_out):
        assert (got.untyped_storage().data_ptr()
                == flat.untyped_storage().data_ptr()), name
        assert got.stride(-1) == 1, name
    assert not ops[5].is_contiguous()
    assert all(t.is_contiguous() for t in ops[:3])


@pytest.mark.parametrize("nstr", [4, 8, 16])
def test_radsrc_plain_on_path_views_equals_contiguous(monkeypatch, nstr):
    ops, umu, _ = path_operands(nstr, 3, monkeypatch)
    assert torch.equal(rad_source_lane_plain(*ops, umu),
                       rad_source_lane_plain(*(o.contiguous() for o in ops),
                                             umu))


@pytest.mark.parametrize("which", [5, 7, 11, 15])
def test_radsrc_wrapper_refuses_non_unit_lane_stride(monkeypatch, which):
    """An operand (gp, kk, b or scale) whose lane axis has stride 2 is
    refused, not copied."""
    ops, umu = captured_operands(8, 3, monkeypatch=monkeypatch)
    wide = torch.zeros(ops[which].shape[:-1] + (2 * ops[which].shape[-1],))
    ops[which] = wide[..., ::2].copy_(ops[which])
    before = launches(rad_source_lane)
    with pytest.raises(ValueError, match="lane stride 2"):
        rad_source_lane(*ops, umu)
    assert launches(rad_source_lane) == before


def test_radsrc_refuses_zero_cosine(monkeypatch):
    ops, _ = captured_operands(4, 2, monkeypatch=monkeypatch)
    with pytest.raises(ValueError, match="nonzero"):
        rad_source_lane_plain(*ops, np.array([0.5, 0.0, -0.5, 0.2]))
