"""The batch cells: back-to-back jobs, each one `run_batch` call over a
job's fresh perturbed columns with a checkpoint directory of its own
(removed after the job), on one card or on every rank of a
`sharding.make_mesh` process grid.

The window runs jobs until `seconds` have passed (the job in flight then
is waited for and counted); the traced run profiles the traffic's
`trace.job`-th job whole.  After the window the reference works out
again `reference_columns` columns drawn from the seed out of every job
the window finished, and the program's integrated fluxes are compared
with it.
"""

from __future__ import annotations

import logging
import statistics
import tempfile
import time

from rtbench.harness import traffic as gen
from rtbench.harness.common import gap, note
from rtbench.harness.observe import Observation

FIELDS = ("fdir", "fdn", "fup")
BATCH_LOG = "sbdart_tpu_torch.batch"


class ChunkRecords(logging.Handler):
    """The times (time.time()) of run_batch's "chunk i/n ... done" log
    records; each also marks the profiler's timeline."""

    def __init__(self, torch):
        super().__init__(logging.INFO)
        self.times = []
        self._torch = torch

    def emit(self, record):
        if "done" in record.getMessage():
            self.times.append(record.created)
            with self._torch.profiler.record_function("rtbench.chunk_done"):
                pass


def job_overhead_s(start: float, times: list) -> float | None:
    """A job's time to its first column chunk's record, less the median
    interval between its later records (what the job pays once: the
    deck, the first band chunk run eagerly, the capture)."""
    if len(times) < 3:
        return None
    steady = statistics.median(b - a for a, b in zip(times[1:], times[2:]))
    return times[0] - start - steady


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, mesh_band: int | None = None) -> dict:
    """Set-up, the window and (on rank 0) the comparison of one run of
    the cell on `device`; `mesh_band` is the band axis of the process
    grid, None on one card; `t_start` is the process's start on the
    perf_counter clock."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from rtbench.harness.trace import Trace
    from rtbench.reference import batch as ref_batch
    from sbdart_tpu_torch.batch import ColumnBatch, run_batch
    from sbdart_tpu_torch.namelist import loads_namelist
    from sbdart_tpu_torch.sharding import make_mesh

    note(t_start, "program imported")
    config, traffic = cell["config"], cell["traffic"]
    on_card = torch.device(device).type == "cuda"
    grid = mesh_band is not None
    rank = dist.get_rank() if grid else 0

    def sync():
        if on_card:
            torch.cuda.synchronize()

    text = gen.namelist_text(config["namelist"])
    cfg = loads_namelist(text).validate()
    mesh = make_mesh(mesh_band) if grid else None
    kw = dict(band_chunk=int(traffic["band_chunk"]),
              col_chunk=int(traffic["col_chunk"]), mesh=mesh)
    log = logging.getLogger(BATCH_LOG)
    log.setLevel(logging.INFO)
    records = ChunkRecords(torch)
    log.addHandler(records)

    # set-up: the kernels, tables and a band-chunk graph at the cell's
    # shapes (run_batch captures its own graph on every call)
    warm = gen.batch_columns(config, traffic, seed, 0, gen.WARMUP,
                             ncols=kw["col_chunk"])
    run_batch(cfg, ColumnBatch(**warm), **kw)
    sync()
    note(t_start, "warm-up done")
    if grid:
        dist.barrier()
    t_window = time.perf_counter()
    setup_s = t_window - t_start

    tr = Trace() if trace else None
    trace_job = int(traffic["trace"]["job"])
    jobs, failed, first_error = [], 0, None
    while True:
        j = len(jobs)
        cols = gen.batch_columns(config, traffic, seed, j)
        if tr is not None and j == trace_job:
            tr.start(torch)
        records.times = []
        t0, e0 = time.perf_counter(), time.time()
        res = None
        try:
            with tempfile.TemporaryDirectory(prefix="rtbench-ck-") as ck:
                with torch.profiler.record_function("rtbench.job"):
                    res = run_batch(cfg, ColumnBatch(**cols),
                                    checkpoint_dir=ck, **kw)
        except Exception as exc:          # counted, and the run fails
            failed += 1
            first_error = first_error or exc
        t1 = time.perf_counter()
        if tr is not None and j == trace_job:
            tr.stop(torch)
        jobs.append({"t0": t0, "t1": t1, "columns": len(cols["csza"]),
                     "overhead_s": job_overhead_s(e0, records.times),
                     "cols": cols, "res": res})
        done = t1 - t_window >= seconds and (tr is None or j >= trace_job)
        stop = (done and rank == 0) or failed > 0
        if grid:                          # rank 0's clock decides for all
            flag = torch.tensor([int(stop)], device=device)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            stop = bool(flag.item())
        if stop:
            break
    log.removeHandler(records)
    sync()
    window = jobs[-1]["t1"] - t_window
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    metrics = {"setup_s": setup_s,
               "columns_per_s": sum(jb["columns"] for jb in jobs)
               / (jobs[-1]["t1"] - jobs[0]["t0"])}

    lanes = kw["col_chunk"] // (mesh.shape["data"] if grid else 1)
    nwl = int(config["shapes"]["wavelengths"])
    nband = -(-nwl // kw["band_chunk"]) // (mesh_band or 1)
    chunks = -(-int(config["columns"]) // kw["col_chunk"])
    shapes = {"nstr": int(cfg.nstr), "layers": int(config["shapes"]["layers"]),
              "columns": lanes * kw["band_chunk"]
              * int(config["shapes"]["k_terms"]),
              "modes": 1, "umu": 0, "planck": bool(config["shapes"]["planck"])}
    obs = Observation(shapes=shapes, trace=tr,
                      solves_traced=chunks * nband if tr else 0,
                      column_chunks_traced=chunks if tr else 0,
                      jobs=[{k: jb[k] for k in ("t0", "t1", "columns",
                                                "overhead_s")}
                            for jb in jobs], collectives=grid)
    if grid:
        stats = [None] * dist.get_world_size()
        dist.all_gather_object(stats, (peak, tr.busy_ns(*tr.bounds())
                                       if tr else 0, failed))
        peak = max(s[0] for s in stats)
        obs.busy_ns_ranks = [s[1] for s in stats]
        failed = sum(s[2] for s in stats)
    out = {"metrics": metrics, "attempted": len(jobs), "failed": failed,
           "error": first_error, "peak": peak, "observation": obs,
           "window_s": window, "gaps": {}}
    if rank != 0:
        return out

    # the reference, on the columns drawn from every job the window
    # finished, once the program's results are all that is kept of it
    done_jobs = [jb for jb in jobs if jb["res"] is not None]
    for jb in jobs:
        jb["res"] = None if jb["res"] is None else {
            f: getattr(jb["res"], f) for f in FIELDS}
    if on_card:
        torch.cuda.empty_cache()
    per = int(config["columns"])
    picks = gen.sample(seed, len(done_jobs) * per,
                       int(traffic["reference_columns"]))
    if not picks:
        out["gaps"] = {f + "_gap": float("inf") for f in FIELDS}
        return out
    sel = {k: np.array([done_jobs[p // per]["cols"][k][p % per]
                        for p in picks]) for k in ref_batch.NAMES}
    want = ref_batch.run(text, sel, dtype=torch.float64, device=device)
    out["gaps"] = {f + "_gap": gap(np.stack(
        [done_jobs[p // per]["res"][f][p % per] for p in picks]), want[f])
        for f in FIELDS}
    return out
