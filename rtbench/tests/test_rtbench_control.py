"""The control (the reference in the program's place, in float32 with
its optical deck in bfloat16) fails a cell's limits where the program
passes them, on the card at a cut size (harness: rtbench/tests/
control.py; at the cells' own sizes it is run by hand on the card, and
its readings are in PERF.md)."""

from __future__ import annotations

import pytest

from rtbench.tests import control, tiny


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["c5-sweep"])
def test_control_fails_where_the_program_passes(card, workload):
    cell = tiny.cell(workload)
    r = control.readings(cell, 2**31 + 3, device=card)
    limits = cell["limits"]
    assert all(r["program"][k] <= lim for k, lim in limits.items()), r
    assert any(r["control"][k] > lim for k, lim in limits.items()), r
