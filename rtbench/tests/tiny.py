"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds, for the
tests that drive the harness without a card (the program then runs its
float64 CPU path)."""

from __future__ import annotations

import copy
import time

from rtbench.harness import manifest

SPECTRA = {"sbdart-c5-batch": dict(wlinf=1.9, wlsup=2.3, wlinc=-200.0)}


def cell(workload: str) -> dict:
    """The cell `workload` with a short spectrum and jobs of 64 columns
    (2 perturbations x 32 zeniths) in chunks of 32."""
    from rtbench.reference.namelist import loads_namelist
    from rtbench.reference.solar import spectral_grid

    c = manifest.cell(workload)
    c = {k: v if k == "per_layer" else copy.deepcopy(v) for k, v in c.items()}
    cfg = c["config"]
    cfg["namelist"].update(SPECTRA[cfg["name"]])
    nwl = len(spectral_grid(loads_namelist(
        " &INPUT\n" + ",\n".join(f"{k}={v}" for k, v in
                                  cfg["namelist"].items()
                                  if not isinstance(v, list))
        + "\n /\n")))
    cfg["shapes"]["wavelengths"] = nwl
    cfg["columns"] = 64
    c["traffic"].update(col_chunk=32, band_chunk=4, reference_columns=6)
    c["traffic"]["trace"]["job"] = 0
    return c


def drive(c: dict, seed: int = 12345, trace: bool = False,
          seconds: float = 0.0) -> dict:
    from rtbench.harness import cell as cell_mod

    return cell_mod.drive(c, seed, seconds, trace, "cpu", time.perf_counter())
