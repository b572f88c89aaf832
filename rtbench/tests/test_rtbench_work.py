"""The frozen work counts (harness/work.py) against chip_smoke.py's
bound_of on the operands the program hands its kernels, at small
shapes on the CPU (the program's float32 route, whose kernel wrappers
take their plain versions there)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rtbench.harness import work


def _spy(monkeypatch, module, name, seen, key):
    fn = getattr(module, name)

    def call(*a, **k):
        out = fn(*a, **k)
        seen.setdefault(key, (a, out if isinstance(out, tuple) else (out,)))
        return out

    monkeypatch.setattr(module, name, call)


def _check(kname, op, shapes, args, outs):
    import chip_smoke

    want = chip_smoke.bound_of(kname, args, outs)
    got = work.OPERATIONS[op](shapes)
    assert got is not None
    assert got[0] == want["bytes"]
    assert got[1] == pytest.approx(want["flops"], rel=1e-12)
    assert work.least_seconds(op, shapes) * 1e3 == pytest.approx(
        want["bound_ms"], rel=1e-12)


def test_batch_solve_work(monkeypatch):
    from sbdart_tpu_torch.batch import ColumnBatch, run_batch
    from sbdart_tpu_torch.kernels import blocktri_rt_streamed
    from sbdart_tpu_torch.namelist import loads_namelist
    from sbdart_tpu_torch.solver import fluxlane

    seen = {}
    _spy(monkeypatch, fluxlane, "eig_beam_scatter_n2", seen, "eig")
    _spy(monkeypatch, blocktri_rt_streamed, "block_thomas_rt_n2", seen, "bvp")
    cfg = loads_namelist(""" &INPUT
   idatm=2, wlinf=1.9, wlsup=2.3, wlinc=-200.0, nothrm=-1,
   zcloud=2, tcloud=10, nre=10, iaer=1, vis=10, albcon=0.2, nstr=4
 /
""").validate()
    run_batch(cfg, ColumnBatch(csza=np.array([0.5, 0.8, 0.3])),
              band_chunk=4, col_chunk=3, dtype="float32", device="cpu")
    a, outs = seen["eig"]
    shapes = {"nstr": 4, "layers": a[0].shape[0], "columns": a[0].shape[-1],
              "modes": 1, "umu": 0, "planck": True}
    assert shapes["columns"] == 3 * 4 * 3
    _check("eig_n2_scatter", "eig", shapes, a, outs)
    a, outs = seen["bvp"]
    _check("blocktri_rt_n2", "bvp", shapes, a, outs)


@pytest.mark.parametrize("radiance", [True, False])
def test_run_solve_work(monkeypatch, radiance):
    from sbdart_tpu_torch.api import run
    from sbdart_tpu_torch.kernels import blocktri_rt_streamed, eig_beam
    from sbdart_tpu_torch.namelist import loads_namelist
    from sbdart_tpu_torch.solver import fluxlane, radlane

    seen = {}
    _spy(monkeypatch, eig_beam, "eig_beam_chain", seen, "eig")
    _spy(monkeypatch, fluxlane, "eig_beam_chain", seen, "eig")
    _spy(monkeypatch, blocktri_rt_streamed, "block_thomas_rt", seen, "bvp")
    _spy(monkeypatch, radlane, "rad_source_lane", seen, "radsrc")
    views = ("nzen=6, uzen=0,30,60,75,120,150, nphi=3, phi=0,90,180, "
             "iout=20" if radiance else "iout=10")
    run(loads_namelist(f""" &INPUT
   idatm=2, iaer=1, vis=10, albcon=0.1, nstr=16, sza=40,
   wlinf=0.25, wlsup=0.26, wlinc=0.005, {views}
 /
"""), dtype="float32", device="cpu")
    cols = 48 * 3
    shapes = {"nstr": 16, "layers": 32, "columns": cols,
              "modes": 16 if radiance else 1, "umu": 6 if radiance else 0,
              "planck": False}
    a, outs = seen["eig"]
    _check("eig_beam", "eig", shapes, a, outs)
    a, outs = seen["bvp"]
    _check("blocktri_rt", "bvp", shapes, a, outs)
    if radiance:
        a, outs = seen["radsrc"]
        _check("radsrc", "radsrc", shapes, a[:-1], outs)
    else:
        assert "radsrc" not in seen and work.radsrc(shapes) is None


def test_uncovered_shapes_give_nothing():
    s = {"nstr": 16, "layers": 65, "columns": 8, "modes": 1, "umu": 0,
         "planck": False}
    assert work.bvp(s) is None                  # B6 streams at 65 layers
    assert work.eig(dict(s, nstr=4)) is None    # B1: not a cell's shape
    assert work.least_seconds("bvp", s) is None
