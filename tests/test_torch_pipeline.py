"""The port's spectral pipeline and CLI against the JAX package's, both in
float64 on CPU, for BASELINE config 1 (clear-sky shortwave, midlatitude
summer, 4 streams, sza 30, albedo 0.2) on a short grid (0.30-1.0 um at
0.05).  Bar: 1e-10 of each field's max (measured 1.2e-13; the port's solve
and the reference's generic route are different algorithms)."""

import dataclasses

import numpy as np
import pytest
import torch

from sbdart_tpu.config import Config as RefConfig
from sbdart_tpu.outputs import format_iout as ref_format_iout
from sbdart_tpu.pipeline import run_pipeline as ref_run_pipeline
from sbdart_tpu_torch import cli
from sbdart_tpu_torch.config import Config
from sbdart_tpu_torch.outputs import format_iout
from sbdart_tpu_torch.pipeline import run_pipeline

CONFIG1 = dict(idatm=2, wlinf=0.30, wlsup=1.0, wlinc=0.05, sza=30.0,
               albcon=0.2, nstr=4, iout=10)
BAR = 1e-10


@pytest.fixture(scope="module")
def both():
    ref = ref_run_pipeline(RefConfig(**CONFIG1).validate())
    got = run_pipeline(Config(**CONFIG1).validate(), dtype=torch.float64,
                       device="cpu")
    return ref, got


def test_pipeline_f64_matches_reference(both):
    ref, got = both
    np.testing.assert_array_equal(got.wl, ref.wl)
    np.testing.assert_array_equal(got.fbeam_toa, ref.fbeam_toa)
    assert got.csza == ref.csza and got.uu is None
    for name in ("fdir", "fdn", "fup", "dfdt", "uavg"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.shape == b.shape and np.isfinite(a).all()
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err < BAR, (name, err)


def _fields(text):
    """Numeric rows of an iout text (tag lines such as '"tbf' dropped)."""
    return [ln.split() for ln in text.splitlines()
            if not ln.startswith('"')]


@pytest.mark.parametrize("iout", [1, 7, 10, 11])
def test_format_iout_matches_reference(both, iout):
    ref, got = both
    r = ref_format_iout(dataclasses.replace(ref, cfg=ref.cfg.replace(iout=iout)))
    g = format_iout(dataclasses.replace(got, cfg=got.cfg.replace(iout=iout)))
    assert [ln for ln in g.splitlines() if ln.startswith('"')] == \
        [ln for ln in r.splitlines() if ln.startswith('"')]
    rl, gl = _fields(r), _fields(g)
    assert [len(x) for x in gl] == [len(x) for x in rl]
    # numbers within the bar of the output's largest magnitude (a level's
    # near-zero diffuse flux carries roundoff of the field's scale)
    scale = max(abs(float(v)) for row in rl for v in row)
    for rrow, grow in zip(rl, gl):
        for rv, gv in zip(rrow, grow):
            if rv != gv:
                assert abs(float(gv) - float(rv)) <= BAR * scale, (rv, gv)


def test_cli_prints_reference_iout10(both, tmp_path, capsys):
    ref, _ = both
    path = tmp_path / "INPUT"
    path.write_text(
        " &INPUT\n   idatm=2, wlinf=0.30, wlsup=1.0, wlinc=0.05,\n"
        "   sza=30.0, albcon=0.2, nstr=4, iout=10\n /\n"
    )
    assert cli.main([str(path)]) == 0
    out = capsys.readouterr().out
    assert out == ref_format_iout(ref)
