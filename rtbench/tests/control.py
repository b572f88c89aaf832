"""The control of the comparison that decides `correct`, and the
program's own readings beside it, for setting and checking the limits.

The configuration states float32 with TF32 off.  TF32 (the nearest
precision below) gives no number here: with it on, the program's float32
path and the reference's both return non-finite fluxes.  So the control
is the next below, bfloat16, where a later change would take it: the
reference put in the program's place, in float32 on the card, with its
optical deck (each column's layer optical depths, single-scattering
albedos and phase-function moments, as the batch recombines them) held
in bfloat16 before the solve.  Beside it: the reference in plain float32
and the program as it runs (the lower reading).  Each is compared with
the float64 reference by the benchmark's own numbers (`<field>_gap`,
harness/common.py:gap) on what one run of the cell checks: a job's
columns drawn from the seed.

On the card, at the cell's own size (the benchmark's runs never run it):
    python3 -m rtbench.tests.control --workload c5-sweep --seeds 1 2 3
one JSON line a seed.  test_rtbench_control.py runs it at a cut size.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from rtbench.harness import manifest
from rtbench.harness import traffic as gen
from rtbench.harness.common import gap

FIELDS = ("fdir", "fdn", "fup")


@contextlib.contextmanager
def deck_in(ref, dtype):
    """The reference batch's solve fed its optical deck rounded to
    `dtype` (and computed on in the solve's own precision)."""
    solve = ref.solve

    def rounded(dtau, ssalb, pmom, **kw):
        return solve(*(x.to(dtype).to(x.dtype) for x in (dtau, ssalb, pmom)),
                     **kw)

    ref.solve = rounded
    try:
        yield
    finally:
        ref.solve = solve


def _gaps(got: dict, want: dict) -> dict:
    return {f + "_gap": gap(got[f], want[f]) for f in FIELDS}


def readings(cell: dict, seed: int, device="cuda",
             with_control: bool = True) -> dict:
    """{"program", "reference_f32", "control"} (the last two only
    `with_control`): each `<field>_gap` -> the widest gap over the columns
    one run of the cell checks."""
    import torch

    from rtbench.reference import batch as ref
    from sbdart_tpu_torch.batch import ColumnBatch, run_batch
    from sbdart_tpu_torch.namelist import loads_namelist

    config, traffic = cell["config"], cell["traffic"]
    if traffic["driver"] != "batch":
        raise ValueError("the control covers the batch driver's cells")
    text = gen.namelist_text(config["namelist"])
    cfg = loads_namelist(text).validate()
    cols = gen.batch_columns(config, traffic, seed, 0)
    picks = gen.sample(seed, len(cols["csza"]),
                       int(traffic["reference_columns"]))
    sel = {k: cols[k][picks] for k in ref.NAMES}
    res = run_batch(cfg, ColumnBatch(**cols),
                    band_chunk=int(traffic["band_chunk"]),
                    col_chunk=int(traffic["col_chunk"]))
    got = {f: getattr(res, f)[picks] for f in FIELDS}
    del res
    want = ref.run(text, sel, dtype=torch.float64, device=device)
    out = {"program": _gaps(got, want)}
    if with_control:
        f32 = torch.float32
        out["reference_f32"] = _gaps(
            ref.run(text, sel, dtype=f32, device=device), want)
        with deck_in(ref, torch.bfloat16):
            out["control"] = _gaps(
                ref.run(text, sel, dtype=f32, device=device), want)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="control readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="how many of the seeds, from the first, also read "
                         "the control and the reference in float32")
    args = ap.parse_args(argv)
    cell = manifest.cell(args.workload)
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        r = readings(cell, seed, with_control=i < args.control_seeds)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **r}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
