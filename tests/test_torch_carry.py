"""The NumPy setup carried into the port: it must equal the JAX package's
bit for bit, and it must import without JAX (the card's machine has
none)."""

import dataclasses
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

from sbdart_tpu.atmosphere import build_profile as ref_build_profile
from sbdart_tpu.config import Config as RefConfig
from sbdart_tpu.optics import build_optical_deck as ref_build_optical_deck
from sbdart_tpu.solar import spectral_grid as ref_spectral_grid
from sbdart_tpu_torch.atmosphere import build_profile
from sbdart_tpu_torch.config import Config
from sbdart_tpu_torch.optics import build_optical_deck
from sbdart_tpu_torch.solar import spectral_grid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_MODULES = ("aerosol_mie", "aerosols", "albedo", "atmospheres",
                "filters", "gas_bands", "gas_bands20", "mie", "refractive",
                "solar", "solar_thekaekara")


def assert_same(a, b, where):
    """Deep, bit-for-bit equality of NumPy data structures."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), where
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a).__name__ == type(b).__name__, where
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif dataclasses.is_dataclass(a):
        assert_same(dataclasses.astuple(a), dataclasses.astuple(b), where)
    elif callable(a):                   # tabulated lambdas: same code
        assert a.__code__.co_code == b.__code__.co_code, where
        assert a.__code__.co_consts == b.__code__.co_consts, where
    else:
        assert a == b, where


@pytest.mark.parametrize("name", DATA_MODULES)
def test_data_module_public_values_equal_reference(name):
    ref = importlib.import_module(f"sbdart_tpu.data.{name}")
    got = importlib.import_module(f"sbdart_tpu_torch.data.{name}")
    pub = sorted(k for k, v in vars(ref).items()
                 if not k.startswith("_") and not callable(v)
                 and not isinstance(v, type(os)) and k != "annotations")
    assert pub == sorted(k for k, v in vars(got).items()
                         if not k.startswith("_") and not callable(v)
                         and not isinstance(v, type(os))
                         and k != "annotations")
    for k in pub:
        assert_same(getattr(ref, k), getattr(got, k), f"{name}.{k}")


def test_packaged_tables_equal_reference():
    for mod, fn, args in (("mie", "tables", ()),
                          ("mie", "moment_tables", ()),
                          ("aerosol_mie", "tables", ()),
                          ("gas_bands20", "tables20", ("h2o",)),
                          ("solar", "solar_table", (3,)),
                          ("atmospheres", "model_atmosphere", (2,))):
        ref = getattr(importlib.import_module(f"sbdart_tpu.data.{mod}"), fn)
        got = getattr(importlib.import_module(f"sbdart_tpu_torch.data.{mod}"),
                      fn)
        assert_same(ref(*args), got(*args), f"{mod}.{fn}{args}")
    for npz in ("mie_tables.npz", "mie_moments.npz", "aerosol_mie.npz"):
        with open(os.path.join(REPO, "sbdart_tpu", "data", npz), "rb") as f:
            want = f.read()
        with open(os.path.join(REPO, "sbdart_tpu_torch", "data", npz),
                  "rb") as f:
            assert f.read() == want, npz


@pytest.mark.parametrize("cfg_kw", [
    dict(idatm=2, wlinf=0.25, wlsup=2.0, wlinc=0.005, sza=30.0,
         albcon=0.2, nstr=4, iout=10),                  # BASELINE config 1
    dict(idatm=4, wlinf=0.4, wlsup=0.8, wlinc=0.05, nstr=4, iout=10,
         tcloud=[5.0, 0, 0, 0, 0], zcloud=[2.0, 0, 0, 0, 0],
         nre=[10.0, 8, 8, 8, 8], iaer=1, vis=15.0),      # cloud + aerosol
])
def test_profile_and_deck_equal_reference(cfg_kw):
    rcfg = RefConfig(**cfg_kw).validate()
    pcfg = Config(**cfg_kw).validate()
    assert_same(dataclasses.asdict(rcfg), dataclasses.asdict(pcfg), "cfg")
    rprof, pprof = ref_build_profile(rcfg), build_profile(pcfg)
    assert_same(rprof, pprof, "profile")
    wl = ref_spectral_grid(rcfg)
    assert_same(wl, spectral_grid(pcfg), "wl")
    rdeck = ref_build_optical_deck(rprof, rcfg, wl, 5, None, None)
    pdeck = build_optical_deck(pprof, pcfg, wl, 5, None, None)
    assert_same(tuple(rdeck), tuple(pdeck), "deck")


def test_port_imports_without_jax():
    mods = ("cli", "pipeline", "solver.fluxlane", "solver.planck",
            "solver.sources", "ops.lane", "kernels.eig_n2_scatter",
            "kernels.eig_beam", "kernels.blocktri_rt",
            "kernels.blocktri_rt_streamed", "kernels._build",
            "kernels.eig_n2", "kernels.radsrc", "solver.radlane",
            "solver.radiance", "solver.brdf", "convert", "solver.albtrn",
            "batch", "sharding")
    code = ("import sys, importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module('sbdart_tpu_torch.' + m)\n"
            "assert 'jax' not in sys.modules, 'jax imported'")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
