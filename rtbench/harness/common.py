"""What every run shares: the refusal to measure without the cards a
cell asks for, the card's description, the guard against JAX in the
process, the comparison numbers, and the result line."""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

# imported top-level module names that may not be loaded in a run (the
# JAX package beside the port shares the port's prefix, so names are
# compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "sbdart_tpu")


class NoCard(RuntimeError):
    pass


def require_cards(torch, count: int) -> None:
    """Raise NoCard unless `count` CUDA cards are visible."""
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: the benchmark measures only on the "
                     "card and has no CPU fallback")
    if torch.cuda.device_count() < count:
        raise NoCard(f"the cell asks for {count} CUDA devices, "
                     f"{torch.cuda.device_count()} are visible")


def forbidden_modules() -> list[str]:
    """The forbidden top-level names among sys.modules."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def power_limit_w() -> float | None:
    """The card's power limit (nvidia-smi), or None where it cannot be
    read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20).stdout.split()
        return float(out[0]) if out else None
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


def device_info(torch, count: int, peak_bytes: int) -> dict:
    """The cards a run used (the CPU only in the tests' drives, which
    bypass run.py's refusal)."""
    if not torch.cuda.is_available():
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0, "power_limit_w": None}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak_bytes),
            "power_limit_w": power_limit_w()}


def note(t_start: float, what: str) -> None:
    """A line on standard error: seconds since the process started."""
    print(f"rtbench: {time.perf_counter() - t_start:.3f} s {what}",
          file=sys.stderr, flush=True)


def gap(got, want) -> float:
    """The widest gap of `got` from `want`, as a share of want's largest
    magnitude (a non-finite value reads as infinite)."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return math.inf
    scale = float(np.abs(want).max())
    d = np.abs(got - want)
    if not np.isfinite(d).all():
        return math.inf
    return float(d.max() / scale) if scale > 0 else float(d.max())


def emit(result: dict, checks: dict) -> None:
    """The result line, last on standard output, with `checks` (name ->
    (number, limit)) last in it and as the last lines of standard
    error."""
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    line = dict(result)
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    print(json.dumps(line), flush=True)


def process_start() -> float:
    """This process's start on the perf_counter clock (from
    /proc/self/stat and the kernel's boot time; the interpreter's start
    where those cannot be read)."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - age
    except (OSError, ValueError, IndexError):
        return _START


_START = time.perf_counter()
