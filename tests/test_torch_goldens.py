"""The port's nstr=8 flux path against the committed iout goldens of the
JAX package (tests/golden/iout/, rendered from the reference's CPU f64
path; see tests/test_iout_goldens.py for the configuration).

The port runs the flux-only iouts of that configuration (1, 7, 10, 11)
in float64 on the CPU.  iout 1, 10 and 11 match the goldens byte for byte.
iout 7 prints the diffuse down flux at the top of the atmosphere, which
is zero up to roundoff (1e-13 of the 1520 W/m2 of the row) and so carries
each route's own rounding: its numbers are held within 1e-10 of the
largest value in their row.
"""

import dataclasses
import os

import pytest
import torch

from sbdart_tpu_torch.config import Config
from sbdart_tpu_torch.outputs import format_iout
from sbdart_tpu_torch.pipeline import run_pipeline

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden", "iout")


@pytest.fixture(scope="module")
def port_result():
    cfg = Config(idatm=2, wlinf=0.55, wlsup=0.65, wlinc=0.05, nstr=8,
                 sza=30.0, albcon=0.2, nzen=2, uzen=[20.0, 60.0],
                 nphi=2, phi=[0.0, 90.0], iout=10)
    return run_pipeline(cfg, dtype=torch.float64, device="cpu")


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
