"""BENCHMARK.json against the benchmark's contract and the files the
harness finds by name."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from rtbench.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
ROOT = manifest.ROOT
BENCH = manifest.load_benchmark()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "rtbench/run.py"]
    assert BENCH["paths"] == ["rtbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(set(names)) == len(names)
        for n in names:
            assert NAME.match(n), n
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        for k in c["reduced"]:
            assert NAME.match(k)


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}


def test_four_chip_cells_at_most_one_in_four():
    chips = [w["chips"] for w in BENCH["workloads"]]
    assert set(chips) <= {1, 4}
    assert chips.count(4) <= max(1, len(chips) // 4)


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in BENCH["workloads"]:
        c = manifest.cell(w["name"])
        names = {m["name"] for m in c["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert c["per_layer"]


def test_per_layer_cells_report_what_they_move():
    for m in BENCH["per_layer"]:
        for w in m["workloads"]:
            c = manifest.cell(w)
            assert m["moves"] in {e["name"] for e in c["end_to_end"]}, (
                m["name"], w)


def test_metric_files_agree_with_the_manifest():
    for m in BENCH["per_layer"]:
        mod = manifest.load_metric(m["name"])
        assert (mod.UNIT, mod.LAYER, mod.MOVES, mod.SOURCE) == (
            m["unit"], m["layer"], m["moves"], m["source"]), m["name"]
        assert callable(mod.read)
        if m["name"].split(".")[0].endswith("_roofline"):
            assert mod.UNIT == "%" and mod.PATTERNS and mod.OPERATION


def test_configuration_files():
    for c in BENCH["configs"]:
        f = ROOT / c["file"]
        assert f.is_file() and c["file"].startswith("rtbench/")
        body = json.loads(f.read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        for k in c["reduced"]:
            assert k in body and k in body["published"]
        assert body["precision"] == "float32" and body["tf32"] is False
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)


def test_every_cell_has_its_files():
    for w in BENCH["workloads"]:
        c = manifest.cell(w["name"])
        assert c["limits"] and all(k.endswith("_gap")
                                   for k in c["limits"])


def test_a_new_cell_is_found_without_editing_a_file(tmp_path):
    """A configuration, a traffic mix with a driver of its own, limits and
    a metric dropped into a copy of the benchmark are found by name."""
    shutil.copytree(ROOT / "rtbench", tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = tmp_path / "rtbench"
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((here / "configs" / "sbdart-c5-batch.json").read_text())
    cfg["name"] = "sbdart-c5-solar"
    cfg["namelist"].update(wlsup=4.0, nothrm=1)
    (here / "configs" / "sbdart-c5-solar.json").write_text(json.dumps(cfg))
    traffic = json.loads((here / "traffic" / "batch-sweep.json").read_text())
    (here / "traffic" / "batch-solar.json").write_text(
        json.dumps(dict(traffic, driver="solar")))
    (here / "drivers" / "solar.py").write_text(
        "def run_cell(cell, seed, *a, **k):\n"
        "    return {'driver': 'solar', 'seed': seed}\n")
    (here / "limits" / "c5-solar.json").write_text('{"fdn_gap": 1e-3}')
    (here / "metrics" / "solve.count.batch.py").write_text(
        'UNIT = "1"\nLAYER = "solve"\nMOVES = "columns_per_s"\n'
        'SOURCE = "device_trace"\n\n\ndef read(obs):\n'
        '    return obs.solves_traced or None\n')
    bench["configs"].append(dict(bench["configs"][0], name="sbdart-c5-solar",
                                 file="rtbench/configs/sbdart-c5-solar.json"))
    bench["workloads"].append({"name": "c5-solar", "config": "sbdart-c5-solar",
                               "traffic": "batch-solar", "chips": 1,
                               "why": "solar only"})
    for m in bench["end_to_end"]:
        if m["name"] == "columns_per_s":
            m["workloads"].append("c5-solar")
    bench["per_layer"].append({"name": "solve.count.batch", "unit": "1",
                               "better": "higher", "source": "device_trace",
                               "layer": "solve", "moves": "columns_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = manifest.cell("c5-solar", root=tmp_path, here=here)
    assert c["config"]["namelist"]["nothrm"] == 1
    assert c["limits"] == {"fdn_gap": 1e-3}
    names = [m["name"] for m in c["per_layer"]]
    assert "solve.count.batch" in names and "columns_per_s" in {
        m["name"] for m in c["end_to_end"]}
    from rtbench.harness import cell as cell_mod

    assert cell_mod.drive(c, 7, 0.0, False, "cpu", 0.0) == {
        "driver": "solar", "seed": 7}
    for name in ("metrics/solve.count.batch.py", "drivers/solar.py"):
        assert not (ROOT / "rtbench" / name).exists()


@pytest.mark.parametrize("workload", ["c5-sweep", "c5-sweep-grid4"])
def test_traffic_is_the_same_size_for_every_seed(workload):
    from rtbench.harness import traffic as gen

    c = manifest.cell(workload)
    a = gen.batch_columns(c["config"], c["traffic"], 1, 0)
    b = gen.batch_columns(c["config"], c["traffic"], 2**31 + 7, 3)
    assert {k: v.shape for k, v in a.items()} == {
        k: v.shape for k, v in b.items()}
    assert len(a["csza"]) == c["config"]["columns"]
    assert not all((a[k] == b[k]).all() for k in a)
    assert all((a[k] == gen.batch_columns(c["config"], c["traffic"], 1, 0)[k]
                ).all() for k in a)
