"""The port's process grid (sbdart_tpu_torch/sharding.py) and the batch
runner on it, on the CPU with gloo: worlds of 8 processes (one thread
each) on 4-band x 2-data and 2 x 4 grids, a column count that is not a
multiple of `data` (2 nd + 1, as __graft_entry__.py:dryrun_multichip
takes), against the single-process port within 1e-6 of each field's max
(__graft_entry__.py:116-123's bar); a world of one through the
process-group route equal to the run without one, bit for bit; the
refusals the reference makes (uneven band chunks, a world the band axis
does not divide).

The workers import torch and the port only: the reference is imported
inside the tests that use it.
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from sbdart_tpu_torch.batch import ColumnBatch, run_batch
from sbdart_tpu_torch.config import Config
from sbdart_tpu_torch.sharding import (
    Mesh,
    init_distributed,
    make_mesh,
    pad_to_multiple,
)

CFG = dict(idatm=2, wlinf=0.4, wlsup=0.7, wlinc=0.05, nstr=4, albcon=0.2)
BAND_CHUNK = 2            # 7 samples: 4 band chunks
GRIDS = (4, 2)            # n_band of the two grids of a world of 8
WORLD = 8
F64 = dict(dtype=torch.float64, device="cpu")


def batch(ncols, seed=1):
    rng = np.random.default_rng(seed)
    return ColumnBatch(csza=rng.uniform(0.3, 1.0, ncols),
                       gas_scale=rng.uniform(0.8, 1.2, ncols),
                       albedo_scale=rng.uniform(0.5, 1.5, ncols))


def ncols_of(n_band):
    nd = WORLD // n_band
    return 2 * nd + 1


def _worker(rank, init_file, out_dir):
    """One rank of the world of 8: each grid's run, and the refusal of a
    band axis that does not divide the world."""
    torch.set_num_threads(1)
    os.environ["SBDART_TPU_DEVICE"] = "cpu"     # gloo, by the default rule
    init_distributed(f"file://{init_file}", WORLD, rank)
    try:
        assert dist.get_backend() == "gloo"
        for n_band in GRIDS:
            mesh = make_mesh(n_band)
            assert mesh.shape == {"band": n_band, "data": WORLD // n_band}
            res = run_batch(Config(**CFG), batch(ncols_of(n_band)),
                            mesh=mesh, band_chunk=BAND_CHUNK,
                            dtype=torch.float64)
            np.savez(os.path.join(out_dir, f"r{rank}_b{n_band}.npz"),
                     fdir=res.fdir, fdn=res.fdn, fup=res.fup,
                     where=[mesh.band_index, mesh.data_index])
        try:
            make_mesh(3)
        except ValueError as e:
            with open(os.path.join(out_dir, f"r{rank}_refused"), "w") as fh:
                fh.write(str(e))
    finally:
        dist.destroy_process_group()


def spawn_world(tmp_path, timeout=300):
    ctx = mp.start_processes(_worker, args=(str(tmp_path / "init"),
                                            str(tmp_path)),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "world of 8 timed out"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    assert not any(p.is_alive() for p in ctx.processes)


def test_world_of_8_grids_match_single_process(tmp_path):
    spawn_world(tmp_path)
    for n_band in GRIDS:
        nd = WORLD // n_band
        single = run_batch(Config(**CFG), batch(ncols_of(n_band)),
                           band_chunk=BAND_CHUNK, **F64)
        for rank in range(WORLD):
            got = np.load(tmp_path / f"r{rank}_b{n_band}.npz")
            assert got["where"].tolist() == [rank // nd, rank % nd]
            for field in ("fdir", "fdn", "fup"):
                a, b = got[field], getattr(single, field)
                assert a.shape == b.shape == (2 * nd + 1, 33)
                assert np.isfinite(a).all() and np.all(got["fdn"] >= -1e-6)
                err = np.abs(a - b).max() / np.abs(b).max()
                assert err < 1e-6, (n_band, rank, field, err)
        # every rank holds the same gathered result
        r0 = np.load(tmp_path / f"r0_b{n_band}.npz")
        for rank in range(1, WORLD):
            got = np.load(tmp_path / f"r{rank}_b{n_band}.npz")
            np.testing.assert_array_equal(got["fdn"], r0["fdn"])
    for rank in range(WORLD):
        text = (tmp_path / f"r{rank}_refused").read_text()
        assert text == "8 devices not divisible by band axis 3"


def test_world_of_one_process_group_route_equals_plain_run(tmp_path):
    """init_distributed with a backend named initializes even a world of
    one; run_batch through its groups (one all-reduce, one all-gather)
    equals the run without a process group to the bit."""
    cfg, b = Config(**CFG), batch(5)
    plain = run_batch(cfg, b, band_chunk=BAND_CHUNK, col_chunk=4, **F64)
    init_distributed(f"file://{tmp_path / 'init'}", 1, 0, backend="gloo")
    try:
        mesh = make_mesh(1)
        assert mesh.distributed and mesh.shape == {"band": 1, "data": 1}
        grouped = run_batch(cfg, b, mesh=mesh, band_chunk=BAND_CHUNK,
                            col_chunk=4, **F64)
    finally:
        dist.destroy_process_group()
    for field in ("fdir", "fdn", "fup"):
        np.testing.assert_array_equal(getattr(grouped, field),
                                      getattr(plain, field))


def test_init_distributed_single_process_is_a_no_op():
    for n in (None, 0, 1):
        init_distributed("file:///nonexistent/init", n, 0)
        assert not dist.is_initialized()
    mesh = make_mesh()
    assert mesh == Mesh({"band": 1, "data": 1}, 0, 0)
    assert not mesh.distributed
    with pytest.raises(ValueError, match="1 devices not divisible by band "
                                         "axis 2"):
        make_mesh(2)


def test_uneven_band_chunks_refused_as_the_reference_does():
    """3 band chunks (7 samples in chunks of 3) on a band axis of 4: the
    reference's shard_map raises on the 8-device CPU mesh, the port a
    ValueError naming both numbers (before any collective)."""
    import jax

    from sbdart_tpu.batch import ColumnBatch as RefColumnBatch
    from sbdart_tpu.batch import run_batch as ref_run_batch
    from sbdart_tpu.config import Config as RefConfig
    from sbdart_tpu.sharding import make_mesh as ref_make_mesh

    assert jax.device_count() == 8
    with pytest.raises(ValueError, match="not evenly divisible"):
        ref_run_batch(RefConfig(**CFG), RefColumnBatch(csza=np.full(5, 0.5)),
                      mesh=ref_make_mesh(4), band_chunk=3)
    grid = Mesh({"band": 4, "data": 2}, 0, 0)
    with pytest.raises(ValueError, match="3 band chunks not divisible by "
                                         "band axis 4"):
        run_batch(Config(**CFG), ColumnBatch(csza=np.full(5, 0.5)),
                  mesh=grid, band_chunk=3, **F64)


@pytest.mark.parametrize("n,m", [(5, 2), (8, 4), (9, 4), (1, 8)])
def test_pad_to_multiple_equals_reference(n, m):
    from sbdart_tpu.sharding import pad_to_multiple as ref_pad

    a = np.random.default_rng(n).uniform(size=(n, 3))
    for axis in (0, 1):
        got, want = pad_to_multiple(a, m, axis), ref_pad(a, m, axis)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("local_rank,process_id,count,want", [
    ("3", 9, 4, 3),         # LOCAL_RANK set: the launcher's word
    (None, 2, 4, 2),        # unset, a process id of this host's cards
    (None, None, 1, 0),     # unset, no process id: card 0
    (None, 4, 4, None),     # unset, past this host's cards: refused
    (None, 5, 0, None),     # unset, no card at all: refused
])
def test_local_rank_takes_launcher_or_refuses(monkeypatch, local_rank,
                                              process_id, count, want):
    """A rank's card on its host: LOCAL_RANK where the launcher sets it;
    without it the process id only where it names a card of this host;
    otherwise a ValueError naming LOCAL_RANK, the process id and the card
    count (no guess at how the launcher placed the ranks)."""
    from sbdart_tpu_torch.sharding import _local_rank

    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    if want is None:
        with pytest.raises(ValueError, match=rf"LOCAL_RANK is unset and "
                           rf"process {process_id} .*\({count} CUDA"):
            _local_rank(process_id)
    else:
        assert _local_rank(process_id) == want


def test_rank_device_is_the_card_init_distributed_set(monkeypatch):
    """On NCCL rank_device returns torch.cuda.current_device()'s card (the
    one init_distributed set), not one worked out from the global rank."""
    from sbdart_tpu_torch.sharding import rank_device

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 6)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert rank_device() == torch.device("cuda", 2)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    assert rank_device() == torch.device("cpu")
