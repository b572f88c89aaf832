"""Process grid and padding utilities on torch.distributed (torch port of
sbdart_tpu/sharding.py).

One process per device.  The (column x solar-angle x band) work is split
over a grid of the world's ranks with two axes, as the reference's
`jax.sharding.Mesh`:

  * `data` -- the flattened column/solar-angle batch (embarrassingly
    parallel, no collectives);
  * `band` -- spectral band chunks; the ONLY reduction of the physics is
    the all-reduce of band-partial spectral integrals over this axis (the
    reference's `psum`; BASELINE.json north star: "host-to-host
    collectives only at spectral flux integration").

Rank r sits at (band r // n_data, data r % n_data), as the reference's
`devices.reshape(n_band, n // n_band)` places device r.  Each rank
computes on its own device: on NCCL worlds the card `init_distributed`
set (`cuda:LOCAL_RANK`), on gloo worlds the CPU (`rank_device`).

The reference's `data_sharding` and `replicated` return JAX
`NamedSharding`s, placements of one global array over many devices of one
controller; a process-per-device design has no such object (each rank
holds its own tensors), so they have no counterpart here.

Launch: `torchrun --nproc-per-node N script.py`, the script calling
`init_distributed(None, world, rank)` from the `WORLD_SIZE` and `RANK`
torchrun exports, or any launcher with a `tcp://host:port` or `file://`
coordinator.  On NCCL a rank's card on its host is `LOCAL_RANK`, which
torchrun sets; a launcher that does not set it may place only one host's
worth of ranks (process ids below the host's card count), and any other
rank refuses to start (`_local_rank`): the launcher alone knows how it
placed the ranks on the hosts.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from sbdart_tpu_torch.dtypes import default_device


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> None:
    """Initialize torch.distributed for multi-process runs.

    A no-op when `num_processes` is None or <= 1, as the reference's,
    unless `backend` is named: then even a world of one is initialized
    (the process-group route on one card).  `coordinator` is the
    rendezvous (`tcp://host:port`, `file:///path`; None: `env://`, as
    torchrun sets it).  The backend defaults to NCCL when this process
    computes on a CUDA device and gloo on the CPU; on NCCL this process's
    card is `cuda:LOCAL_RANK` (see `_local_rank` where LOCAL_RANK is
    unset)."""
    if backend is None and (num_processes is None or num_processes <= 1):
        return
    if backend is None:
        backend = "nccl" if default_device().type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(_local_rank(process_id))
    dist.init_process_group(
        backend,
        init_method=coordinator or "env://",
        world_size=1 if num_processes is None else num_processes,
        rank=0 if process_id is None else process_id,
    )


def _local_rank(process_id: int | None) -> int:
    """This process's card on its host: `LOCAL_RANK` where the launcher
    sets it.  Without it, `process_id` (0 when None) only where it names a
    card of this host, as in a world on one host; past the host's cards a
    ValueError, since only the launcher knows its placement of ranks."""
    env = os.environ.get("LOCAL_RANK")
    if env is not None:
        return int(env)
    pid = 0 if process_id is None else process_id
    count = torch.cuda.device_count()
    if 0 <= pid < count:
        return pid
    raise ValueError(
        f"LOCAL_RANK is unset and process {pid} names no card of this "
        f"host ({count} CUDA devices): set LOCAL_RANK to this process's "
        f"card on its host")


def rank_device() -> torch.device:
    """The device this rank computes on: in an NCCL world the card
    `init_distributed` set (`torch.cuda.current_device()`), the CPU in a
    gloo world, `dtypes.default_device()` without torch.distributed."""
    if not dist.is_initialized():
        return default_device()
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (band, data) grid over the world's ranks.

    `shape` is {"band": nb, "data": nd}; `band_index`/`data_index` place
    this rank; `band_group` is the process group of the ranks along the
    band axis that share this rank's data index (the all-reduce of band
    partials), `data_group` that of the ranks along the data axis that
    share its band index (the gather of the columns).  Both are None
    without torch.distributed: a grid of one rank, no collectives."""
    shape: dict
    band_index: int
    data_index: int
    band_group: object = None
    data_group: object = None

    @property
    def distributed(self) -> bool:
        return self.band_group is not None


def make_mesh(n_band: int = 1) -> Mesh:
    """Grid over (band, data).  n_band=1 -> pure data parallelism.

    Collective over the world when torch.distributed is initialized:
    every rank creates every row and column group, in one order."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % n_band:
        raise ValueError(f"{n} devices not divisible by band axis {n_band}")
    nd = n // n_band
    if not dist.is_initialized():
        return Mesh({"band": n_band, "data": nd}, 0, 0)
    rank = dist.get_rank()
    grid = np.arange(n).reshape(n_band, nd)
    band_group = data_group = None
    for d in range(nd):                    # the band axis: one column each
        g = dist.new_group(grid[:, d].tolist())
        if rank % nd == d:
            band_group = g
    for b in range(n_band):                # the data axis: one row each
        g = dist.new_group(grid[b].tolist())
        if rank // nd == b:
            data_group = g
    return Mesh({"band": n_band, "data": nd}, rank // nd, rank % nd,
                band_group, data_group)


def pad_to_multiple(a: np.ndarray, m: int, axis: int = 0):
    """Pad axis to a multiple of m (edge-replicate); returns (padded, n_orig)."""
    n = a.shape[axis]
    r = (-n) % m
    if r == 0:
        return a, n
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, r)
    return np.pad(a, pad, mode="edge"), n
