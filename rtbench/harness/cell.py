"""One run of one cell: set-up, the window, the comparison with the
reference, the per-layer readers and the result line."""

from __future__ import annotations

import math
import sys
import traceback

from rtbench.harness import manifest
from rtbench.harness.common import device_info, emit, forbidden_modules


def drive(cell: dict, seed: int, seconds: float, trace: bool, device,
          t_start: float, mesh_band=None) -> dict:
    """The traffic's driver (rtbench/drivers/<traffic["driver"]>.py) on
    this process."""
    driver = manifest.load_driver(cell["traffic"]["driver"], cell["here"])
    return driver.run_cell(cell, seed, seconds, trace, device, t_start,
                           mesh_band=mesh_band)


def checks_of(cell: dict, out: dict) -> dict:
    """name -> (number, limit) of every compared number of the cell
    (limits/<workload>.json: number -> its limit; a number the run did
    not read is infinite)."""
    return {name: (out["gaps"].get(name, math.inf), limit)
            for name, limit in cell["limits"].items()}


def result(cell: dict, out: dict, trace: bool, device_desc: dict) -> tuple:
    """The result line's object and its checks."""
    checks = checks_of(cell, out)
    correct = (out["failed"] == 0 and out["attempted"] > 0
               and all(v <= lim for v, lim in checks.values()))
    if trace:
        obs = out["observation"]
        metrics = {}
        for m in cell["per_layer"]:
            v = m["reader"].read(obs)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        tr = obs.trace
        busy = (sum(obs.busy_ns_ranks) / len(obs.busy_ns_ranks)
                if obs.busy_ns_ranks else tr.busy_ns(*tr.bounds()))
        device_desc = dict(device_desc, busy_s=busy / 1e9,
                           window_s=tr.window_s)
        line = {"correct": correct, "attempted": out["attempted"],
                "failed": out["failed"], "metrics": metrics,
                "device": device_desc, "breakdown": tr.breakdown()}
    else:
        line = {"correct": correct, "attempted": out["attempted"],
                "failed": out["failed"],
                "metrics": {m["name"]: {
                    "value": out["metrics"][m["name"].split(".")[0]],
                    "unit": m["unit"]} for m in cell["end_to_end"]},
                "device": device_desc}
    return line, checks


def finish(cell: dict, out: dict, trace: bool, count: int) -> int:
    """Print the result of a finished run (rank 0); 1 without a result
    where the process holds JAX or the JAX package."""
    import torch

    if out["error"] is not None:
        traceback.print_exception(out["error"], file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"refused: the process holds {bad}", file=sys.stderr)
        return 1
    line, checks = result(cell, out, trace,
                          device_info(torch, count, out["peak"]))
    emit(line, checks)
    return 0


def main(workload: str, seed: int, seconds: float, trace: bool,
         t_start: float) -> int:
    import torch

    from rtbench.harness.common import NoCard, note, require_cards

    note(t_start, "torch imported")
    cell = manifest.cell(workload)
    chips = int(cell["workload"]["chips"])
    try:
        require_cards(torch, chips)
    except NoCard as exc:
        print(f"rtbench: {exc}", file=sys.stderr)
        return 3
    torch.zeros(1, device="cuda")
    note(t_start, "CUDA initialised")
    if chips > 1:
        from rtbench.harness import grid

        return grid.launch(cell, workload, seed, seconds, trace, t_start)
    out = drive(cell, seed, seconds, trace, "cuda", t_start)
    return finish(cell, out, trace, 1)
