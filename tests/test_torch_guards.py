"""Requests the lane paths do not take run on the generic path and match
the reference (float64, CPU): stream counts whose N = nstr/2 is odd or
above 8, flux-only solves on a BRDF surface, and all-mode solves with or
without user angles, thermal or not (`route`, named below); nothing is
refused for N.  ibcnd=1 runs the slab albedo/transmission mode and matches
the reference's.

The reference runs under one jax.jit (tests/test_torch_generic.py:
ref_solve); the bar is 1e-9 of each field's max (measured <= 6e-15).
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from sbdart_tpu.config import Config as RefConfig
from sbdart_tpu.namelist import loads_namelist as ref_loads_namelist
from sbdart_tpu.outputs import format_albtrn as ref_format_albtrn
from sbdart_tpu.pipeline import run_albtrn as ref_run_albtrn
from sbdart_tpu.pipeline import run_pipeline as ref_run_pipeline
from sbdart_tpu.solver.brdf import HapkeBrdf
from sbdart_tpu.solver.brdf import RpvBrdf as RefRpvBrdf
from sbdart_tpu_torch import cli
from sbdart_tpu_torch.config import Config
from sbdart_tpu_torch.namelist import loads_namelist
from sbdart_tpu_torch.pipeline import run_albtrn, run_pipeline
from sbdart_tpu_torch.solver.disort import route, solve_rte
from test_torch_generic import ref_solve, worst
from test_torch_radlane import port

DTAU = np.full((2, 4), 0.1)
SSALB = np.full((2, 4), 0.5)


def pmom(nstr):
    """HG-like moments, at least nstr + 1 of them (TMS reads them all)."""
    return 0.5 ** np.arange(max(5, nstr + 1)) * np.ones((2, 4, 1))


PMOM = pmom(4)


THERMAL = dict(planck=True, temper=np.full((2, 5), 280.0), wvnlo=800.0,
               wvnhi=900.0)
UMU = dict(umu=np.array([0.5]))
RADIANCE = dict(onlyfl=False, umu=np.array([0.5]), phi=np.array([0.0]))

REQUESTS = {
    "nstr6": dict(nstr=6),                             # odd N
    "nstr32": dict(nstr=32),                           # N > 8
    "all_modes": dict(onlyfl=False),                   # no umu, no phi
    "thermal_radiance_umu": dict(THERMAL, onlyfl=False, **UMU),
    "hapke_flux": dict(brdf=HapkeBrdf()),              # flux-only BRDF
    "rpv_flux": dict(brdf=RefRpvBrdf()),
    "nstr6_radiance": dict(nstr=6, **RADIANCE),        # odd N
    "nstr2": dict(nstr=2),                             # odd N
    "nstr20_radiance": dict(nstr=20, **RADIANCE),      # N > 8
    "all_modes_phi_only": dict(onlyfl=False, phi=np.array([0.0])),
    "thermal_all_modes": dict(THERMAL, onlyfl=False),  # no umu, no phi
}


@pytest.mark.parametrize("name", list(REQUESTS))
def test_generic_requests_run_and_match_reference(name):
    kw = dict(dict(nstr=4, fbeam=1.0, umu0=0.5, albedo=0.1), **REQUESTS[name])
    args = (DTAU, SSALB, pmom(kw["nstr"]))
    if kw.get("umu") is not None and kw.get("phi") is None:
        # user cosines without azimuths: the reference fails on them, the
        # port says what is missing; with one azimuth both run
        with pytest.raises(ValueError, match="phi"):
            port(args, kw, torch.float64)
        kw["phi"] = np.array([0.0])
    got = port(args, kw, torch.float64)
    errs = worst(got, ref_solve(args, kw, np.float64))
    assert max(errs.values()) <= 1e-9, errs
    if kw.get("umu") is not None:
        assert got.uu.shape == (2, 5, 1, 1)
    else:
        assert got.uu is None


def test_route_names_each_request():
    """The path of each request, decided without running anything."""
    hapke = object()
    for kw, path in [
        (dict(nstr=4, onlyfl=True, brdf=None), "flux_lane"),
        (dict(nstr=16, onlyfl=True, brdf=None), "flux_lane"),
        (dict(nstr=8, onlyfl=False, brdf=hapke, umu=[0.5], phi=[0.0]),
         "radiance_lane"),
        (dict(nstr=6, onlyfl=True, brdf=None), "generic"),
        (dict(nstr=2, onlyfl=True, brdf=None), "generic"),
        (dict(nstr=20, onlyfl=True, brdf=None), "generic"),
        (dict(nstr=8, onlyfl=True, brdf=hapke), "generic"),
        (dict(nstr=16, onlyfl=False, brdf=None), "generic"),
        (dict(nstr=4, onlyfl=False, brdf=None, phi=[0.0]), "generic"),
        (dict(nstr=10, onlyfl=False, brdf=None, umu=[0.5], phi=[0.0]),
         "generic"),
    ]:
        assert route(**kw) == path, kw
    # past N = 8 every request takes the generic path, fluxes or radiances,
    # on either surface: nothing is refused for N
    for nstr in (18, 20, 32):
        for kw in (dict(onlyfl=True, brdf=None),
                   dict(onlyfl=True, brdf=hapke),
                   dict(onlyfl=False, brdf=None, umu=[0.5], phi=[0.0])):
            assert route(nstr=nstr, **kw) == "generic", (nstr, kw)


def test_radiance_solves_run():
    """Radiances at given umu and phi, thermal or not, on either surface,
    are the radiance slice's and run."""
    from sbdart_tpu_torch.solver.brdf import RpvBrdf

    for kw in (RADIANCE, dict(THERMAL, **RADIANCE),
               dict(RADIANCE, brdf=RpvBrdf())):
        out = solve_rte(DTAU, SSALB, PMOM, nstr=4, fbeam=1.0, umu0=0.5,
                        albedo=0.1, dtype=torch.float64, device="cpu", **kw)
        assert out.uu.shape == (2, 5, 1, 1)
        assert bool(torch.isfinite(out.uu).all())


PIPELINES = {
    # thermal samples (1.9-2.1 um crosses the 2 um switch) with radiances
    # at nstr=6 (N odd)
    "thermal_nstr6_radiance": [dict(idatm=2, wlinf=1.9, wlsup=2.1,
                                    wlinc=0.05, nstr=6, iout=20, nzen=1,
                                    uzen=[0.0, 0, 0, 0, 0])],
    # radiances at nstr 6 and 32, fluxes at nstr 32
    "radiance_and_nstr32": [
        dict(idatm=2, wlinf=0.5, wlsup=0.6, wlinc=0.05, nstr=nstr,
             iout=iout, nzen=1, uzen=[0.0, 0, 0, 0, 0])
        for nstr, iout in ((6, 20), (32, 20), (32, 10))],
}


@pytest.mark.parametrize("name", list(PIPELINES))
def test_pipeline_generic_requests_match_reference(name):
    """run_pipeline on the stream counts of the generic path, against the
    reference's float64 pipeline (chunks of 3 wavelengths: the grids hold
    3 to 5)."""
    for cfg in PIPELINES[name]:
        ref = ref_run_pipeline(RefConfig(**cfg).validate(), chunk=3)
        got = run_pipeline(Config(**cfg).validate(), chunk=3,
                           dtype=torch.float64, device="cpu")
        names = ("fdir", "fdn", "fup", "dfdt", "uavg")
        names += ("uu",) if cfg["iout"] == 20 else ()
        for field in names:
            a, b = getattr(got, field), np.asarray(getattr(ref, field))
            assert a.shape == b.shape and np.isfinite(a).all(), field
            err = np.abs(a - b).max() / np.abs(b).max()
            assert err < 1e-7, (cfg["nstr"], field, err)


def test_ibcnd1_refused_by_albtrn_and_cli(tmp_path, monkeypatch):
    """ibcnd=1 is refused by run_pipeline (it names run_albtrn) and by
    run_albtrn without incidence angles, as the reference's; with them,
    run_albtrn and the CLI text match the reference's (float64)."""
    monkeypatch.setenv("SBDART_TPU_DEVICE", "cpu")
    cfg = Config(idatm=2, wlinf=0.5, wlsup=0.6, wlinc=0.05, nstr=4,
                 ibcnd=1).validate()
    with pytest.raises(ValueError, match="incidence angles"):
        run_albtrn(cfg)
    with pytest.raises(ValueError, match="run_albtrn"):
        run_pipeline(cfg)
    text = (" &INPUT\n   idatm=2, wlinf=0.5, wlsup=0.6, wlinc=0.05, "
            "nstr=4, ibcnd=1,\n   nzen=3, uzen=0,45,75, albcon=0.1\n /\n")
    ref = ref_run_albtrn(ref_loads_namelist(text).validate())
    got = run_albtrn(loads_namelist(text).validate())
    assert got.umu.tolist() == ref.umu.tolist()
    for field in ("albmed", "trnmed"):
        a, b = getattr(got, field), np.asarray(getattr(ref, field))
        assert a.shape == b.shape == (3, 3) and np.isfinite(a).all()
        assert np.abs(a - b).max() <= 1e-9 * np.abs(b).max(), field
    path = tmp_path / "INPUT"
    path.write_text(text)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main([str(path)]) == 0
    want = ref_format_albtrn(ref).splitlines()
    lines = buf.getvalue().splitlines()
    assert len(lines) == len(want) == 12
    for a, b in zip(lines, want):
        if a != b:     # the last printed digit may part: numbers to 1e-9
            np.testing.assert_allclose(np.array(a.split(), float),
                                       np.array(b.split(), float), rtol=1e-9)
