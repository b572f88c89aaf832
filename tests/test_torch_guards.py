"""What the port does not run yet raises NotImplementedError naming the
ROADMAP slice that brings it, instead of computing something else: the
reference's generic path (Queue A item 7) serves stream counts whose
N = nstr/2 is odd or above 8, flux-only solves on a BRDF surface and
radiances without user angles, thermal or not."""

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


THERMAL = dict(planck=True, temper=np.full((2, 5), 280.0), wvnlo=800.0,
               wvnhi=900.0)
UMU = dict(umu=np.array([0.5]))
RADIANCE = dict(onlyfl=False, umu=np.array([0.5]), phi=np.array([0.0]))


@pytest.mark.parametrize("kw,slice_name", [
    (dict(nstr=6), "Queue A item 7"),
    (dict(nstr=32), "Queue A item 7"),
    (dict(onlyfl=False), "radiance"),
    (dict(THERMAL, onlyfl=False, **UMU), "radiance slice"),
    (dict(brdf=object()), "BRDF"),
])
def test_solve_rte_refuses_other_slices(kw, slice_name):
    kw = dict(dict(nstr=4, fbeam=1.0, umu0=0.5, albedo=0.1), **kw)
    with pytest.raises(NotImplementedError, match=slice_name):
        solve_rte(DTAU, SSALB, PMOM, dtype=torch.float64, **kw)


@pytest.mark.parametrize("kw", [
    dict(brdf=object()),                               # flux-only BRDF
    dict(nstr=6, **RADIANCE),                          # odd N
    dict(nstr=2),                                      # odd N
    dict(nstr=20, **RADIANCE),                         # N > 8
    dict(onlyfl=False, phi=np.array([0.0])),           # radiance, no umu
    dict(THERMAL, onlyfl=False),                       # no umu, no phi
])
def test_generic_path_requests_name_item_7(kw):
    kw = dict(dict(nstr=4, fbeam=1.0, umu0=0.5, albedo=0.1), **kw)
    with pytest.raises(NotImplementedError, match="Queue A item 7"):
        solve_rte(DTAU, SSALB, PMOM, dtype=torch.float64, **kw)


def test_radiance_solves_run():
    """Radiances at given umu and phi, thermal or not, on either surface,
    are the radiance slice's and run."""
    from sbdart_tpu_torch.solver.brdf import RpvBrdf

    for kw in (RADIANCE, dict(THERMAL, **RADIANCE),
               dict(RADIANCE, brdf=RpvBrdf())):
        out = solve_rte(DTAU, SSALB, PMOM, nstr=4, fbeam=1.0, umu0=0.5,
                        albedo=0.1, dtype=torch.float64, **kw)
        assert out.uu.shape == (2, 5, 1, 1)
        assert bool(torch.isfinite(out.uu).all())


def test_pipeline_refuses_thermal_samples():
    """Thermal samples run with fluxes and with radiances (iout=20); a
    radiance run at a stream count of the generic path (nstr=6: N odd)
    is refused, thermal samples or not."""
    cfg = Config(idatm=2, wlinf=1.9, wlsup=2.1, wlinc=0.05, nstr=6, iout=20,
                 nzen=1, uzen=[0.0, 0, 0, 0, 0]).validate()
    with pytest.raises(NotImplementedError, match="Queue A item 7"):
        run_pipeline(cfg, device="cpu")


def test_pipeline_refuses_radiance_and_nstr16():
    """Radiance runs at nstr 4, 8 and 16 are served (tests/
    test_torch_goldens.py); stream counts of the generic path are
    refused, with radiances (iout=20) or without."""
    for nstr, iout in ((6, 20), (32, 20), (32, 10)):
        cfg = Config(idatm=2, wlinf=0.5, wlsup=0.6, wlinc=0.05, nstr=nstr,
                     iout=iout, nzen=1,
                     uzen=[0.0, 0, 0, 0, 0]).validate()
        with pytest.raises(NotImplementedError, match="Queue A item 7"):
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
