"""Checkpoint resume on a process grid (sbdart_tpu_torch/batch.py), on the
CPU with gloo: worlds of 2 ranks (2 band x 1 data and 1 x 2) and of 4 (2
x 2), one thread each, f64, 7 columns in column chunks of 3 (three
chunks, the last padded to the data axis).

Every rank writes each chunk's checkpoint, and a chunk is restored only
where every rank holds its file, so a resume equals the first run bit for
bit however the ranks' directories disagree:

  * a shared directory: the resume reuses every file (one poisoned file
    shows on every rank) and is otherwise equal to the first run;
  * a directory of its own per rank, the last chunk's file deleted on one
    rank and poisoned on the others: every rank recomputes that chunk
    (the poison does not show, the file is rewritten) and restores the
    others (their files are not rewritten);
  * a directory of its own per rank, one of them empty: every rank
    recomputes every chunk.

Each recomputed chunk runs the grid's collectives inside one
`batch.collectives` span (sbdart_tpu_torch/tracing.py), which every run
records.

A rank that decided alone would skip chunks its partners recompute, and
the grid's collectives would pair different chunks (wrong sums) or wait
for a partner that has finished (a hang, which the deadline turns into a
failure).  The workers import torch and the port only.
"""

import json
import os
import shutil
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from sbdart_tpu_torch import tracing
from sbdart_tpu_torch.batch import ColumnBatch, run_batch
from sbdart_tpu_torch.config import Config
from sbdart_tpu_torch.sharding import init_distributed, make_mesh

CFG = dict(idatm=2, wlinf=0.4, wlsup=0.7, wlinc=0.05, nstr=4, albcon=0.2)
BAND_CHUNK = 2            # 7 samples: 4 band chunks
NCOLS, COL_CHUNK = 7, 3   # chunks 0-3, 3-6, 6-7
FILES = ["cols_0_3.npz", "cols_3_6.npz", "cols_6_7.npz"]
GRIDS = [(2, 2), (2, 1), (4, 2)]          # (world, n_band)
FIELDS = ("fdir", "fdn", "fup")
ODD_RANK = 1              # the rank whose directory disagrees


def batch(ncols, seed=1):
    rng = np.random.default_rng(seed)
    return ColumnBatch(csza=rng.uniform(0.3, 1.0, ncols),
                       gas_scale=rng.uniform(0.8, 1.2, ncols),
                       albedo_scale=rng.uniform(0.5, 1.5, ncols))


def poison(path):
    """Overwrite a checkpoint's fdir with 7.0 in place."""
    with np.load(path) as z:
        arrays = {f: z[f] for f in FIELDS}
    arrays["fdir"] = arrays["fdir"] * 0 + 7.0
    np.savez(path, **arrays)


def listing(ck):
    return sorted(os.listdir(ck)) if os.path.isdir(ck) else []


def inodes(ck):
    """Each chunk file's inode: a file rewritten through os.replace gets a
    new one, a file restored keeps its own."""
    paths = {f: os.path.join(ck, f) for f in FILES}
    return {f: os.stat(p).st_ino for f, p in paths.items()
            if os.path.exists(p)}


def _worker(rank, world, n_band, init_file, root):
    """One rank: the first runs (own and shared directories), then the
    three resumes, saving each result and each directory's state.  The
    own directories of the resumes start as copies of the shared one, so
    each case starts from the same files whichever ranks wrote."""
    torch.set_num_threads(1)
    os.environ["SBDART_TPU_DEVICE"] = "cpu"     # gloo, by the default rule
    init_distributed(f"file://{init_file}", world, rank)
    try:
        mesh = make_mesh(n_band)
        own = os.path.join(root, f"own{rank}")
        shared = os.path.join(root, "shared")
        state = {}

        def run(tag, ck):
            tracing.clear()
            with tracing.recording():
                res = run_batch(Config(**CFG), batch(NCOLS), mesh=mesh,
                                band_chunk=BAND_CHUNK, col_chunk=COL_CHUNK,
                                checkpoint_dir=ck, dtype=torch.float64)
            np.savez(os.path.join(root, f"r{rank}_{tag}.npz"),
                     **{f: getattr(res, f) for f in FIELDS})
            dist.barrier()          # every rank's writes to a shared dir done
            state[tag] = dict(
                files=listing(ck), ino=inodes(ck),
                spans=[[s.name, s.attrs.get("lo"), s.attrs.get("hi")]
                       for s in tracing.spans()],
                restored=tracing.counters().get("batch.restored_chunks", 0))

        run("first_own", own)
        run("first_shared", shared)
        os.makedirs(own, exist_ok=True)
        for f in FILES:
            shutil.copyfile(os.path.join(shared, f), os.path.join(own, f))
        # case 1: the shared directory, one file poisoned for every rank
        dist.barrier()
        if rank == 0:
            poison(os.path.join(shared, FILES[0]))
        dist.barrier()
        run("shared", shared)
        # case 2: the last chunk's file gone on one rank, poisoned on the rest
        if rank == ODD_RANK:
            os.remove(os.path.join(own, FILES[-1]))
        else:
            poison(os.path.join(own, FILES[-1]))
        state["before_disagree"] = inodes(own) if rank != ODD_RANK else {}
        run("disagree", own)
        # case 3: one rank's directory empty
        if rank == ODD_RANK:
            shutil.rmtree(own)
            os.makedirs(own)
        state["before_empty"] = inodes(own) if rank != ODD_RANK else {}
        run("empty", own)
        with open(os.path.join(root, f"r{rank}_state.json"), "w") as fh:
            json.dump(state, fh)
    finally:
        dist.destroy_process_group()


def spawn(world, n_band, root, timeout=180):
    ctx = mp.start_processes(_worker, args=(world, n_band, str(root / "init"),
                                            str(root)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=2):
            assert time.monotonic() < deadline, (
                f"world of {world} (band axis {n_band}) timed out")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    assert not any(p.is_alive() for p in ctx.processes)


@pytest.fixture(scope="module", params=GRIDS,
                ids=[f"world{w}_band{b}" for w, b in GRIDS])
def grid(request, tmp_path_factory):
    world, n_band = request.param
    root = tmp_path_factory.mktemp(f"world{world}_band{n_band}")
    spawn(world, n_band, root)

    def result(rank, tag):
        with np.load(root / f"r{rank}_{tag}.npz") as z:
            return {f: z[f] for f in FIELDS}

    states = [json.loads((root / f"r{r}_state.json").read_text())
              for r in range(world)]
    return world, result, states


def assert_equal(got, want, rank, tag):
    for f in FIELDS:
        assert got[f].shape == (NCOLS, 33), (rank, tag, f)
        np.testing.assert_array_equal(got[f], want[f],
                                      err_msg=f"rank {rank} {tag} {f}")


def test_first_run_every_rank_writes_its_checkpoints(grid):
    """Each rank's own directory holds every chunk (and only rank 0's the
    run metadata), no temporary file is left, the shared directory's run
    equals the own directories' and every rank holds the same result."""
    world, result, states = grid
    first = result(0, "first_own")
    assert np.isfinite(first["fdn"]).all()
    for rank in range(world):
        meta = ["run_metadata.json"] if rank == 0 else []
        assert states[rank]["first_own"]["files"] == sorted(FILES + meta)
        assert states[rank]["first_shared"]["files"] == sorted(
            FILES + ["run_metadata.json"])
        assert_equal(result(rank, "first_own"), first, rank, "first_own")
        assert_equal(result(rank, "first_shared"), first, rank,
                     "first_shared")


def test_shared_dir_resume_reuses_every_file(grid):
    world, result, states = grid
    first = result(0, "first_own")
    for rank in range(world):
        got = result(rank, "shared")
        np.testing.assert_array_equal(got["fdir"][:3], 7.0)     # the poison
        got["fdir"][:3] = first["fdir"][:3]
        assert_equal(got, first, rank, "shared")
        # nothing was recomputed, so nothing was rewritten
        assert (states[rank]["shared"]["ino"]
                == states[rank]["first_shared"]["ino"])


def test_resume_recomputes_a_chunk_one_rank_lacks(grid):
    world, result, states = grid
    first = result(0, "first_own")
    for rank in range(world):
        assert_equal(result(rank, "disagree"), first, rank, "disagree")
        assert set(FILES) <= set(states[rank]["disagree"]["files"])
        if rank == ODD_RANK:
            continue
        before, after = states[rank]["before_disagree"], states[rank][
            "disagree"]["ino"]
        assert after[FILES[-1]] != before[FILES[-1]]        # recomputed
        for f in FILES[:-1]:
            assert after[f] == before[f]                     # restored


def test_resume_with_one_rank_dir_empty_recomputes_all(grid):
    world, result, states = grid
    first = result(0, "first_own")
    for rank in range(world):
        assert_equal(result(rank, "empty"), first, rank, "empty")
        assert set(FILES) <= set(states[rank]["empty"]["files"])
        if rank != ODD_RANK:
            before, after = states[rank]["before_empty"], states[rank][
                "empty"]["ino"]
            assert all(after[f] != before[f] for f in FILES)


def test_collectives_span_each_recomputed_chunk(grid):
    """The grid's all-reduce and all-gather run inside one
    `batch.collectives` span per recomputed column chunk, between its
    band chunks' solves and the wait for its results; restored chunks
    run none and are counted."""
    world, _, states = grid
    chunks = [[0, 3], [3, 6], [6, 7]]
    for rank in range(world):
        for tag, solved in (("first_own", chunks), ("shared", []),
                            ("disagree", chunks[-1:]),
                            ("empty", chunks)):
            spans = states[rank][tag]["spans"]
            collectives = [s[1:] for s in spans
                           if s[0] == "batch.collectives"]
            assert collectives == solved, (rank, tag)
            assert states[rank][tag]["restored"] == 3 - len(solved)
            phases = [s[0] for s in spans if s[0] in (
                "batch.bands", "batch.collectives", "batch.collect")]
            assert phases == ["batch.bands", "batch.collectives",
                              "batch.collect"] * len(solved), (rank, tag)
