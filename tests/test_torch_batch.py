"""The port's batch runner (sbdart_tpu_torch/batch.py) against the
reference's (sbdart_tpu/batch.py), float64 on the CPU, on
tests/test_sharding.py's configuration: perturbed columns over a solar
band, and over a band crossing 2 um with cloud and aerosol (the Planck
source on, every chunk); then the checks of tests/test_sharding.py:35-85
on the port (single column against the pipeline, perturbations act,
checkpoint/resume).

Bar against the reference: 1e-9 of each field's max (measured <= 5e-13).
"""

import json
import os

import numpy as np
import pytest
import torch

from sbdart_tpu.batch import ColumnBatch as RefColumnBatch
from sbdart_tpu.batch import run_batch as ref_run_batch
from sbdart_tpu.config import Config as RefConfig
from sbdart_tpu.sharding import make_mesh as ref_make_mesh
from sbdart_tpu_torch.batch import ColumnBatch, run_batch
from sbdart_tpu_torch.config import Config
from sbdart_tpu_torch.outputs import integrate_spectral
from sbdart_tpu_torch.pipeline import run_pipeline

CFG = dict(idatm=2, wlinf=0.4, wlsup=0.7, wlinc=0.05, nstr=4, albcon=0.2)
CONFIGS = {
    "solar": CFG,
    "thermal_cloud_aerosol": dict(CFG, wlinf=1.8, wlsup=2.3,
                                  tcloud=[5.0, 0, 0, 0, 0],
                                  zcloud=[2.0, 0, 0, 0, 0], iaer=1),
}
F64 = dict(dtype=torch.float64, device="cpu")


def perturbed(n=16, seed=0):
    """Every scaling of ColumnBatch drawn from a seeded generator."""
    rng = np.random.default_rng(seed)
    return dict(csza=rng.uniform(0.2, 1.0, n),
                gas_scale=rng.uniform(0.8, 1.2, n),
                cld_scale=rng.uniform(0.5, 1.5, n),
                aer_scale=rng.uniform(0.5, 1.5, n),
                albedo_scale=rng.uniform(0.5, 1.5, n))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_run_batch_matches_reference(name):
    params = perturbed()
    want = ref_run_batch(RefConfig(**CONFIGS[name]),
                         RefColumnBatch(**params), mesh=ref_make_mesh(1),
                         band_chunk=4)
    got = run_batch(Config(**CONFIGS[name]), ColumnBatch(**params),
                    band_chunk=4, **F64)
    for field in ("fdir", "fdn", "fup"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.shape == w.shape == (16, 33) and np.isfinite(g).all()
        assert np.abs(g - w).max() <= 1e-9 * np.abs(w).max(), field
    np.testing.assert_array_equal(got.z, want.z)
    np.testing.assert_array_equal(got.csza, want.csza)


def test_matches_pipeline_single_column():
    """Batch runner with trivial scales must match the serial pipeline."""
    cfg = Config(**CFG)
    b = ColumnBatch(csza=np.array([0.5] * 8), gas_scale=np.ones(8))
    res = run_batch(cfg, b, band_chunk=4, **F64)
    ref = run_pipeline(cfg.replace(sza=60.0), **F64)
    np.testing.assert_allclose(res.fdir[0] + res.fdn[0],
                               integrate_spectral(ref, ref.fdir + ref.fdn),
                               rtol=1e-6)
    np.testing.assert_allclose(res.fup[0], integrate_spectral(ref, ref.fup),
                               rtol=1e-6)
    assert np.max(np.abs(res.fup - res.fup[:1])) < 1e-9


def test_perturbations_act():
    b = ColumnBatch(
        csza=np.array([0.8, 0.8, 0.8, 0.8] * 2),
        gas_scale=np.array([1.0, 3.0, 1.0, 3.0] * 2),
        albedo_scale=np.array([1.0, 1.0, 2.0, 2.0] * 2),
    )
    r = run_batch(Config(**CFG), b, band_chunk=4, **F64)
    # more gas -> less surface flux; higher albedo -> more upward
    assert r.fdn[1, -1] + r.fdir[1, -1] < r.fdn[0, -1] + r.fdir[0, -1]
    assert r.fup[2, 0] > r.fup[0, 0]


def test_checkpoint_resume(tmp_path):
    cfg = Config(**CFG)
    b = ColumnBatch(**perturbed(8))
    ck = str(tmp_path / "ck")
    r1 = run_batch(cfg, b, band_chunk=4, col_chunk=4, checkpoint_dir=ck, **F64)
    files = sorted(f for f in os.listdir(ck) if f.endswith(".npz"))
    assert files == ["cols_0_4.npz", "cols_4_8.npz"]
    with open(os.path.join(ck, "run_metadata.json")) as fh:
        meta = json.load(fh)
    assert meta["n_columns"] == 8 and meta["mesh"] == {"band": 1, "data": 1}
    assert meta["torch_version"] == torch.__version__
    assert meta["device"] == "cpu" and meta["world_size"] == 1
    # resume from every checkpoint reproduces the run bit for bit
    r2 = run_batch(cfg, b, band_chunk=4, col_chunk=4, checkpoint_dir=ck, **F64)
    for field in ("fdir", "fdn", "fup"):
        np.testing.assert_array_equal(getattr(r2, field), getattr(r1, field))
    # resume must reuse shards (poison one file's values to prove reuse)
    poison = np.load(os.path.join(ck, files[0]))
    np.savez(os.path.join(ck, files[0]), fdir=poison["fdir"] * 0 + 7.0,
             fdn=poison["fdn"], fup=poison["fup"])
    r3 = run_batch(cfg, b, band_chunk=4, col_chunk=4, checkpoint_dir=ck, **F64)
    np.testing.assert_allclose(r3.fdir[:4], 7.0)
    np.testing.assert_array_equal(r3.fdir[4:], r1.fdir[4:])
    np.testing.assert_array_equal(r3.fdn, r1.fdn)
