"""Per-layer metric `device.idle_share.grid` (device; moves
columns_per_s.grid; from device_trace): `device.idle_share.batch` read
on the grid cell, rank 0, with the time the card spent only in NCCL
kernels counted as idle (they spin there while they wait for the
slowest rank)."""

from rtbench.harness import manifest

_BASE = manifest.load_metric("device.idle_share.batch")
UNIT, LAYER, SOURCE = _BASE.UNIT, _BASE.LAYER, _BASE.SOURCE
MOVES = "columns_per_s.grid"


def collective(name):
    return "nccl" in name.lower()


def read(obs):
    return _BASE.idle(obs, skip=collective)
