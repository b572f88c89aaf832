"""What a cell is made of, found by name: BENCHMARK.json at the root of
the checkout, the configuration `configs/<config>.json`, the traffic
mix `traffic/<traffic>.json`, the driver that traffic names
`drivers/<driver>.py`, the limits of its comparison
`limits/<workload>.json` and each per-layer metric's reader
`metrics/<metric>.py`.  A cell that a later change adds brings these
files; no existing file is edited for it."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]       # rtbench/
ROOT = HERE.parent                               # the checkout


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str, here: Path = HERE) -> dict:
    """rtbench/<kind>/<name>.json."""
    return json.loads((Path(here) / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str, here: Path = HERE):
    """The module rtbench/<kind>/<name>.py, loaded from its file."""
    path = Path(here) / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"rtbench_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str, here: Path = HERE):
    """The reader module of the per-layer metric `name`
    (rtbench/metrics/<name>.py): UNIT, LAYER, MOVES and read(obs)."""
    return load_module("metrics", name, here)


def load_driver(name: str, here: Path = HERE):
    """The driver of a traffic kind (rtbench/drivers/<name>.py), whose
    run_cell runs one run of a cell on this process."""
    return load_module("drivers", name, here)


def applies(metric: dict, workload: str, reported: set) -> bool:
    """Whether a metric of BENCHMARK.json is reported by `workload`: one
    with a `workloads` list where it names the cell; a per-layer metric
    without one wherever its `moves` metric is reported (`reported`, the
    cell's end-to-end names); an end-to-end metric without one
    everywhere."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in reported
    return True


def cell(workload: str, root: Path = ROOT, here: Path = HERE) -> dict:
    """Everything one cell of BENCHMARK.json needs: its workload entry,
    the rtbench/ it was read from (`here`, where its driver is found),
    configuration, traffic, limits, and its end-to-end and per-layer
    metrics (the BENCHMARK.json entries; the per-layer ones with their
    readers)."""
    bench = load_benchmark(root)
    (w,) = [w for w in bench["workloads"] if w["name"] == workload]
    e2e = [m for m in bench["end_to_end"] if applies(m, workload, set())]
    names = {m["name"] for m in e2e}
    per = [dict(m, reader=load_metric(m["name"], here))
           for m in bench["per_layer"] if applies(m, workload, names)]
    return assemble(w, load_json("limits", workload, here), e2e, per, here)


def assemble(w: dict, limits: dict, e2e: list, per: list,
             here: Path = HERE) -> dict:
    return {"workload": w, "here": str(here),
            "config": load_json("configs", w["config"], here),
            "traffic": load_json("traffic", w["traffic"], here),
            "limits": limits, "end_to_end": e2e, "per_layer": per}
