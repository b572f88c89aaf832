"""The port's dtype/device policy and its NumPy-to-torch carriers."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sbdart_tpu.atmosphere import build_profile as ref_build_profile
from sbdart_tpu.config import Config as RefConfig
from sbdart_tpu.optics import build_optical_deck as ref_build_optical_deck
from sbdart_tpu.solar import spectral_grid as ref_spectral_grid
from sbdart_tpu.solver.eig import angular_tables as ref_angular_tables
from sbdart_tpu_torch import dtypes
from sbdart_tpu_torch.convert import (
    deck_to_torch,
    rte_inputs_to_torch,
    tables_to_torch,
)
from sbdart_tpu_torch.solver.eig import angular_tables


def test_policy_f64_on_cpu_and_tf32_off(monkeypatch):
    monkeypatch.delenv("SBDART_TPU_DTYPE", raising=False)
    assert dtypes.default_dtype("cpu") == torch.float64
    assert dtypes.default_dtype("cuda") == torch.float32
    monkeypatch.setenv("SBDART_TPU_DTYPE", "float32")
    assert dtypes.default_dtype("cpu") == torch.float32
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    with pytest.raises(ValueError):
        dtypes.parse_dtype("bfloat16")


def test_angular_tables_equal_reference():
    for nstr in (4, 8, 16):
        ref, got = ref_angular_tables(nstr, 3), angular_tables(nstr, 3)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g, r)


def test_reference_deck_and_tables_carry_to_torch():
    """The reference's own OpticalDeck and AngularTables become tensors
    with the same values (float64 exact; float32 the rounded values)."""
    cfg = RefConfig(idatm=2, wlinf=0.5, wlsup=0.7, wlinc=0.1,
                    nstr=4).validate()
    wl = ref_spectral_grid(cfg)
    deck = ref_build_optical_deck(ref_build_profile(cfg), cfg, wl, 5,
                                  None, None)
    t64 = deck_to_torch(deck, "cpu", torch.float64)
    for name, r, g in zip(deck._fields, deck, t64):
        assert g.dtype == torch.float64, name
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
    t32 = deck_to_torch(deck, "cpu", "float32")
    np.testing.assert_array_equal(t32.dtau.numpy(),
                                  deck.dtau.astype(np.float32))
    tab = tables_to_torch(ref_angular_tables(4, 1), "cpu", torch.float64)
    np.testing.assert_array_equal(tab.mu.numpy(), ref_angular_tables(4, 1).mu)
    inp = rte_inputs_to_torch("cpu", torch.float32, fbeam=1.0,
                              albedo=np.array([0.1, 0.2]), temper=None)
    assert inp["fbeam"].dtype == torch.float32 and inp["temper"] is None
    assert inp["albedo"].shape == (2,)


def test_cli_module_runs_without_card(tmp_path):
    """`python -m sbdart_tpu_torch.cli INPUT` prints the iout=10 line on a
    machine without a CUDA device (float64 on the CPU)."""
    path = tmp_path / "INPUT"
    path.write_text(" &INPUT\n   idatm=2, wlinf=0.5, wlsup=0.6, wlinc=0.05,"
                    "\n   sza=30, albcon=0.2, nstr=4, iout=10\n /\n")
    proc = subprocess.run(
        [sys.executable, "-m", "sbdart_tpu_torch.cli", str(path)],
        capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert proc.returncode == 0, proc.stderr
    vals = [float(v) for v in proc.stdout.split()]
    assert len(vals) == 9 and all(np.isfinite(vals))
    assert abs(vals[7] / vals[6] - 0.2) < 1e-4      # botup / botdn
