"""A run with the timed path broken underneath reads `correct` false; a
sound one reads it true.  The harness's look for a card is skipped and
the cut cells run the program's CPU route; every other step of a run is
the benchmark's own."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from rtbench.harness import cell as cell_mod
from rtbench.tests import faults, tiny

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _correct(workload, seed=2**31 + 11):
    c = tiny.cell(workload)
    out = tiny.drive(c, seed=seed)
    line, checks = cell_mod.result(c, out, False, {"platform": "cpu"})
    return line["correct"], checks


@pytest.mark.parametrize("workload", ["c5-sweep"])
@pytest.mark.parametrize("fault", [None, "altered", "half_left_out"])
def test_fault_reads_not_correct(cpu_program, monkeypatch, workload, fault):
    if fault is not None:
        getattr(faults, fault)(monkeypatch)
    correct, checks = _correct(workload)
    assert correct is (fault is None), checks


GRID = """
import sys, time
sys.path.insert(0, {root!r})
from rtbench.harness import grid
from rtbench.tests import faults, tiny
if __name__ == "__main__":
    loader = getattr(faults, {loader!r})
    rc = grid.launch(tiny.cell("c5-sweep-grid4"), "c5-sweep-grid4", 2**33 + 5,
                     0.0, False, time.perf_counter(), backend="gloo",
                     device_of_rank=grid.cpu_of, loader=loader)
    raise SystemExit(rc)
"""


@pytest.mark.parametrize("loader,want", [("sound_cell", True),
                                         ("no_exchange_cell", False),
                                         ("jax_in_rank1_cell", None)])
def test_grid_faults(tmp_path, loader, want):
    """The grid cell on four gloo processes of the CPU: sound; with the
    band all-reduce left out; with a module named `jax` loaded in rank 1
    alone, which prints no result and names what it found."""
    script = tmp_path / "grid_run.py"
    script.write_text(GRID.format(root=ROOT, loader=loader))
    r = subprocess.run([sys.executable, str(script)], cwd=ROOT,
                       env=dict(os.environ, SBDART_TPU_DEVICE="cpu",
                                OMP_NUM_THREADS="1"),
                       capture_output=True, text=True, timeout=600)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    if want is None:
        assert r.returncode != 0 and not lines
        assert "rank 1 holds ['jax']" in r.stderr, r.stderr[-3000:]
        return
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(lines[-1])
    assert line["correct"] is want, line["checks"]
    assert line["device"]["count"] == 4
