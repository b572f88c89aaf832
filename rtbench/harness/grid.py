"""A cell on a process grid: one process per card (this process is rank
0, the others are spawned), NCCL over a TCP rendezvous on a port picked
at run time, the traffic's `mesh.band` band ranks; rank 0 prints the
result.  Every rank looks for JAX and the JAX package in its own process
once its window has closed; a spawned rank that holds one exits 1, and
then no result is printed.  Every process it starts is joined before it
returns."""

from __future__ import annotations

import multiprocessing
import os
import socket
import sys

from rtbench.harness.common import forbidden_modules

JOIN_S = 300


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_main(workload, seed, seconds, trace, t_start, rank, world, port,
              backend, device_of_rank, loader):
    """One rank's run (the spawned ranks' entry, rank 0's too); `loader`
    makes the cell from its name in every rank.  Rank 0 returns the cell
    and its run's outcome."""
    import torch.distributed as dist

    from rtbench.harness import cell as cell_mod
    from sbdart_tpu_torch.sharding import init_distributed

    os.environ["LOCAL_RANK"] = str(rank)
    cell = loader(workload)
    init_distributed(f"tcp://127.0.0.1:{port}", world, rank, backend=backend)
    try:
        if rank == 0 and backend == "nccl":
            from sbdart_tpu_torch.kernels import _build

            _build.library()              # one build for the world
        dist.barrier()
        device = device_of_rank(rank)
        out = cell_mod.drive(cell, seed, seconds, trace, device, t_start,
                             mesh_band=int(cell["traffic"]["mesh"]["band"]))
    finally:
        dist.destroy_process_group()
    return cell, out


def rank_entry(workload, seed, seconds, trace, t_start, rank, *rest):
    """A spawned rank: its run, then the guard against JAX in its
    process (exit 1, naming what it holds)."""
    rank_main(workload, seed, seconds, trace, t_start, rank, *rest)
    bad = forbidden_modules()
    if bad:
        print(f"rtbench: refused: rank {rank} holds {bad}", file=sys.stderr,
              flush=True)
        raise SystemExit(1)


def cuda_of(rank):
    return f"cuda:{rank}"


def cpu_of(rank):
    return "cpu"


def launch(cell, workload, seed, seconds, trace, t_start, *,
           backend="nccl", device_of_rank=cuda_of, loader=None) -> int:
    """Run the cell on `cell["workload"]["chips"]` ranks and print rank
    0's result once every rank has ended; 1 where a rank failed."""
    from rtbench.harness import manifest

    loader = manifest.cell if loader is None else loader
    world = int(cell["workload"]["chips"])
    port = free_port()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_entry, args=(
        workload, seed, seconds, trace, t_start, r, world, port, backend,
        device_of_rank, loader)) for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        cell, out = rank_main(workload, seed, seconds, trace, t_start, 0,
                              world, port, backend, device_of_rank, loader)
    finally:
        for p in procs:
            p.join(JOIN_S)
            if p.is_alive():
                p.kill()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        print(f"rtbench: ranks exited with {bad}", file=sys.stderr)
        return 1
    # every rank has ended: the checks are the last lines of stderr
    from rtbench.harness import cell as cell_mod

    return cell_mod.finish(cell, out, trace, world)
