"""The port's nstr=8 flux and radiance paths against the committed iout
goldens of the JAX package (tests/golden/iout/, rendered from the
reference's CPU f64 path; see tests/test_iout_goldens.py for the
configuration).

The port runs every iout of that configuration in float64 on the CPU:
the flux-only ones (1, 7, 10, 11) from a flux run (iout=10), the radiance
ones (5, 6, 20, 21, 22, 23) from a radiance run (iout=20, which also asks
for 65 phase moments), as the reference's pipeline does.  All match the
goldens byte for byte except iout 7, which prints the diffuse down flux at
the top of the atmosphere: zero up to roundoff (1e-13 of the 1520 W/m2 of
the row), it carries each route's own rounding, so its numbers are held
within 1e-10 of the largest value in their row.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from sbdart_tpu_torch.config import Config
from sbdart_tpu_torch.outputs import format_iout
from sbdart_tpu_torch.pipeline import run_pipeline

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden", "iout")


GOLDEN_CONFIG = dict(idatm=2, wlinf=0.55, wlsup=0.65, wlinc=0.05, nstr=8,
                     sza=30.0, albcon=0.2, nzen=2, uzen=[20.0, 60.0],
                     nphi=2, phi=[0.0, 90.0])


@pytest.fixture(scope="module")
def port_result():
    return run_pipeline(Config(**GOLDEN_CONFIG, iout=10), chunk=3,
                        dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def port_radiance_result():
    return run_pipeline(Config(**GOLDEN_CONFIG, iout=20), chunk=3,
                        dtype=torch.float64, device="cpu")


def _golden(iout):
    with open(os.path.join(GOLDEN_DIR, f"iout{iout:02d}.txt")) as fh:
        return "".join(ln for ln in fh.read().splitlines(keepends=True)
                       if not ln.startswith("#"))


def _render(res, iout):
    return format_iout(dataclasses.replace(res,
                                           cfg=res.cfg.replace(iout=iout)))


@pytest.mark.parametrize("iout", [1, 10, 11])
def test_port_matches_golden_bytes(port_result, iout):
    assert _render(port_result, iout) == _golden(iout)


def test_port_matches_golden_iout7_to_roundoff(port_result):
    got, want = _render(port_result, 7), _golden(7)
    gl, wl = got.splitlines(), want.splitlines()
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        gv, wv = [float(x) for x in g.split()], [float(x) for x in w.split()]
        assert len(gv) == len(wv)
        scale = max(abs(x) for x in wv)
        assert all(abs(a - b) <= 1e-10 * scale for a, b in zip(gv, wv)), \
            (g, w)


@pytest.mark.parametrize("iout", [5, 6, 20, 21, 22, 23])
def test_port_matches_radiance_golden_bytes(port_radiance_result, iout):
    res = port_radiance_result
    assert res.uu.shape == (3, res.nlev, 2, 2)
    assert _render(port_radiance_result, iout) == _golden(iout)


@pytest.mark.parametrize("nstr", [4, 16])
def test_port_radiance_run_at_nstr(nstr):
    """The radiance pipeline at the other stream counts of the slice, with
    thermal samples past 2 um: finite radiances at every level, and at the
    top of the atmosphere the satellite-view (upward, umu > 0) radiances of
    the solar samples are positive."""
    cfg = Config(idatm=2, wlinf=1.8, wlsup=2.2, wlinc=0.2, nstr=nstr,
                 sza=30.0, albcon=0.2, nzen=3, uzen=[0.0, 45.0, 135.0],
                 nphi=2, phi=[0.0, 90.0], iout=20)
    res = run_pipeline(cfg, chunk=3, dtype=torch.float64, device="cpu")
    assert res.uu.shape == (3, res.nlev, 3, 2) and np.isfinite(res.uu).all()
    assert (res.uu[0, 0, :2] > 0.0).all()
    np.testing.assert_allclose(res.umu, np.cos(np.deg2rad([0.0, 45.0, 135.0])))
