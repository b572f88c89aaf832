"""Faults planted under the timed path, for the tests that see `correct`
come out false.  Each installer patches the program in this process;
the loaders (picklable, module level) install theirs in every rank of a
process grid before they hand back the cut cell."""

from __future__ import annotations

import os
import sys
import types

import numpy as np

from rtbench.tests import tiny


def altered(monkeypatch):
    """Every solve's upward flux altered by 5% where it is produced."""
    from sbdart_tpu_torch import batch

    solve = batch.solve_rte

    def wrong(*a, **k):
        out = solve(*a, **k)
        return out._replace(flup=out.flup * 1.05)

    monkeypatch.setattr(batch, "solve_rte", wrong)


def half_left_out(monkeypatch):
    """Half of each batch computed, the other half given the mean of the
    computed half: every other column of a run_batch call."""
    from sbdart_tpu_torch import batch

    run_batch = batch.run_batch

    def half_batch(cfg, cols, **kw):
        keep = np.arange(0, len(cols), 2)
        res = run_batch(cfg, batch.ColumnBatch(**{
            k: getattr(cols, k)[keep] for k in (
                "csza", "gas_scale", "cld_scale", "aer_scale",
                "albedo_scale")}), **dict(kw, checkpoint_dir=None))
        out = {}
        for f in ("fdir", "fdn", "fup"):
            a = np.empty((len(cols),) + getattr(res, f).shape[1:])
            a[keep] = getattr(res, f)
            a[1::2] = getattr(res, f).mean(axis=0)
            out[f] = a
        return batch.BatchResult(csza=cols.csza, z=res.z, **out)

    monkeypatch.setattr(batch, "run_batch", half_batch)


class _Patch:
    """monkeypatch's setattr for a spawned rank (kept for its life)."""

    def setattr(self, obj, name, value):
        setattr(obj, name, value)


def no_exchange():
    """The band-partial integrals' all-reduce left out (float tensors;
    the integer flags of the checkpoint and window decisions still go)."""
    import torch
    import torch.distributed as dist

    reduce = dist.all_reduce

    def skip(t, *a, **k):
        if t.is_floating_point():
            return None
        return reduce(t, *a, **k)

    _Patch().setattr(dist, "all_reduce", skip)
    assert torch.distributed.all_reduce is skip


def sound_cell(workload):
    return tiny.cell(workload)


def no_exchange_cell(workload):
    no_exchange()
    return tiny.cell(workload)


def jax_in_rank1_cell(workload):
    """A stub module named `jax` loaded in rank 1 alone (grid.py sets
    LOCAL_RANK before the loader runs)."""
    if os.environ.get("LOCAL_RANK") == "1":
        sys.modules["jax"] = types.ModuleType("jax")
    return tiny.cell(workload)
