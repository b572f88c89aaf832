"""What the benchmark may load, read and write, and its refusal to
measure without a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from rtbench.harness import manifest
from rtbench.harness.common import FORBIDDEN

ROOT = manifest.ROOT
HERE = ROOT / "rtbench"


def _python(code: str, env: dict | None = None, cwd=ROOT):
    full = dict(os.environ, **(env or {}))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=full,
                          capture_output=True, text=True, timeout=600)


def test_forbidden_names_are_whole_top_level_names():
    import rtbench.harness.common as common

    saved = dict(sys.modules)
    try:
        sys.modules["sbdart_tpu_torch_like"] = object()
        assert "sbdart_tpu" not in common.forbidden_modules()
        sys.modules["sbdart_tpu.x"] = object()
        assert "sbdart_tpu" in common.forbidden_modules()
    finally:
        for k in set(sys.modules) - set(saved):
            del sys.modules[k]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole run of a cut cell on the CPU, then the modules it holds."""
    r = _python(
        "import sys; sys.path.insert(0, '.')\n"
        "from rtbench.tests import tiny\n"
        "from rtbench.harness.common import forbidden_modules\n"
        "out = tiny.drive(tiny.cell('c5-sweep'))\n"
        "assert out['failed'] == 0, out['error']\n"
        "print('LOADED', sorted(forbidden_modules()))\n",
        env={"SBDART_TPU_DEVICE": "cpu"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "LOADED []" in r.stdout


def test_the_reference_imports_nothing_of_the_program():
    mods = sorted("rtbench.reference." + str(p.relative_to(
        HERE / "reference").with_suffix("")).replace(os.sep, ".")
        for p in (HERE / "reference").rglob("*.py")
        if p.name != "__init__.py")
    r = _python("import sys; sys.path.insert(0, '.')\n"
                "import importlib\n"
                f"for m in {mods!r}: importlib.import_module(m)\n"
                "tops = {n.split('.')[0] for n in sys.modules}\n"
                "print('TOPS', sorted(tops & {'sbdart_tpu_torch', "
                "'sbdart_tpu', 'jax', 'chip_smoke'}))\n")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "TOPS []" in r.stdout
    for p in (HERE / "reference").rglob("*.py"):
        for line in p.read_text().splitlines():
            if line.lstrip().startswith(("import ", "from ")):
                assert "sbdart_tpu" not in line and "jax" not in line, (
                    p, line)


def test_nothing_reads_the_jax_package_records():
    bench_py = "bench" + ".py"
    bench_dir = "benchmarks" + "/"
    for p in HERE.rglob("*.py"):
        text = p.read_text()
        assert bench_py not in text and bench_dir not in text, p
        for name in FORBIDDEN:
            assert f"import {name}\n" not in text, p
            assert f"from {name} " not in text and f"from {name}." \
                not in text, p


def test_it_refuses_to_measure_without_a_card():
    r = subprocess.run(
        [sys.executable, "rtbench/run.py", "--workload", "c5-sweep",
         "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert not [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    assert "no CUDA device" in r.stderr


def test_it_fails_with_only_the_benchmark_files(tmp_path):
    """A checkout of BENCHMARK.json and rtbench/ alone: the program is
    missing, and the run fails without a result, whatever the card."""
    import shutil

    shutil.copytree(HERE, tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch; torch.cuda.is_available = lambda: True;"
         "torch.cuda.device_count = lambda: 4;"
         "sys.argv = ['run.py', '--workload', 'c5-sweep', '--seed', '5',"
         " '--seconds', '1'];"
         "sys.path.insert(0, 'rtbench'); import run;"
         "raise SystemExit(run.main())"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert not [ln for ln in r.stdout.splitlines() if ln.startswith("{")]


AUDIT = r'''
import os, sys, json
sys.path.insert(0, ".")
writes = []
def hook(event, args):
    if event == "open" and args[0] is not None and not isinstance(args[0], int):
        mode, flags = args[1], args[2]
        if (mode and any(c in str(mode) for c in "wax+")) or (
                flags and flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT)):
            writes.append(os.path.abspath(str(args[0])))
    elif event in ("os.mkdir", "os.rename", "os.replace", "os.remove",
                   "os.rmdir", "shutil.rmtree", "os.truncate"):
        writes.append(os.path.abspath(str(args[0])))
sys.addaudithook(hook)
from rtbench.tests import tiny
out = tiny.drive(tiny.cell("c5-sweep"), trace=False)
assert out["failed"] == 0, out["error"]
print("WRITES", json.dumps(writes))
'''


def test_runs_write_only_where_they_may(tmp_path):
    home, xdg, tmp = (tmp_path / d for d in ("home", "xdg", "tmp"))
    for d in (home, xdg, tmp):
        d.mkdir()
    r = _python(AUDIT, env={"SBDART_TPU_DEVICE": "cpu", "HOME": str(home),
                            "XDG_CACHE_HOME": str(xdg), "TMPDIR": str(tmp)})
    assert r.returncode == 0, r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("WRITES")]
    writes = json.loads(line[0][len("WRITES "):])
    assert writes, "the batch's checkpoints should show"
    allowed = [str(p) for p in (ROOT, home, xdg, tmp)]
    bad = [w for w in writes if w != os.devnull and not any(
        w == a or w.startswith(a + os.sep) for a in allowed)]
    assert not bad, bad
    assert not [w for w in writes if w.startswith("/dev/shm")]
