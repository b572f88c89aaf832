#!/usr/bin/env python3
"""The benchmark of sbdart_tpu_torch, the PyTorch and CUDA port.

    python3 rtbench/run.py --workload NAME --seed N --seconds S --trace 0|1

run from the root of a checkout on a machine with the cards the cell asks
for (BENCHMARK.json).  It prints one JSON line last on standard output:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with --trace 1 its per-layer ones), `device` and, traced, a
`breakdown`; then `checks`, each number compared with the plain
reference beside its limit (also the last lines of standard error).
Without a CUDA card, or with fewer than the cell asks for, it exits 3
and prints no result.
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def cache_dirs(root: str) -> None:
    """Every compiler and kernel cache at a fixed path in the checkout."""
    base = os.path.join(root, "build", "rtbench")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(base, sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    cache_dirs(ROOT)
    from rtbench.harness.common import process_start

    t_start = process_start()
    from rtbench.harness import cell

    return cell.main(args.workload, args.seed, args.seconds,
                     bool(args.trace), t_start)


if __name__ == "__main__":
    raise SystemExit(main())
