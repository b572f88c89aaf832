"""What this slice of the port does not run yet raises NotImplementedError
naming the ROADMAP slice that brings it, instead of computing something
else."""

import numpy as np
import pytest
import torch

from sbdart_tpu_torch import cli
from sbdart_tpu_torch.config import Config
from sbdart_tpu_torch.pipeline import run_albtrn, run_pipeline
from sbdart_tpu_torch.solver.disort import solve_rte

DTAU = np.full((2, 4), 0.1)
SSALB = np.full((2, 4), 0.5)
PMOM = 0.5 ** np.arange(5) * np.ones((2, 4, 5))


@pytest.mark.parametrize("kw,slice_name", [
    (dict(planck=True, temper=np.full((2, 5), 280.0), wvnlo=800.0,
          wvnhi=900.0), "thermal"),
    (dict(nstr=8), "nstr 8/16"),
    (dict(onlyfl=False, umu=np.array([0.5]), phi=np.array([0.0])),
     "radiance"),
    (dict(brdf=object()), "BRDF"),
])
def test_solve_rte_refuses_other_slices(kw, slice_name):
    kw = dict(dict(nstr=4, fbeam=1.0, umu0=0.5, albedo=0.1), **kw)
    with pytest.raises(NotImplementedError, match=slice_name):
        solve_rte(DTAU, SSALB, PMOM, dtype=torch.float64, **kw)


def test_pipeline_refuses_thermal_samples():
    """Beyond 2 um the reference turns the Planck source on for the whole
    run (pipeline.py:245-268); the port must not drop it silently."""
    cfg = Config(idatm=2, wlinf=1.9, wlsup=2.1, wlinc=0.05, nstr=4).validate()
    with pytest.raises(NotImplementedError, match="thermal"):
        run_pipeline(cfg, device="cpu")
    cfg = Config(idatm=2, wlinf=0.5, wlsup=0.6, wlinc=0.05, nstr=4,
                 nothrm=0).validate()
    with pytest.raises(NotImplementedError, match="thermal"):
        run_pipeline(cfg, device="cpu")


def test_pipeline_refuses_radiance_and_nstr16():
    cfg = Config(idatm=2, wlinf=0.5, wlsup=0.6, wlinc=0.05, nstr=4, iout=20,
                 nzen=1, uzen=[0.0, 0, 0, 0, 0]).validate()
    with pytest.raises(NotImplementedError, match="radiance"):
        run_pipeline(cfg, device="cpu")
    cfg = Config(idatm=2, wlinf=0.5, wlsup=0.6, wlinc=0.05,
                 nstr=16).validate()
    with pytest.raises(NotImplementedError, match="nstr 8/16"):
        run_pipeline(cfg, device="cpu")


def test_ibcnd1_refused_by_albtrn_and_cli(tmp_path):
    cfg = Config(idatm=2, wlinf=0.5, wlsup=0.6, wlinc=0.05, nstr=4,
                 ibcnd=1).validate()
    with pytest.raises(NotImplementedError, match="ibcnd=1"):
        run_albtrn(cfg)
    with pytest.raises(ValueError, match="run_albtrn"):
        run_pipeline(cfg)
    path = tmp_path / "INPUT"
    path.write_text(" &INPUT\n   ibcnd=1, nzen=1, uzen=30, nstr=4\n /\n")
    with pytest.raises(NotImplementedError, match="ibcnd=1"):
        cli.main([str(path)])
