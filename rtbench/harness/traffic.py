"""The one traffic generator.  It reads a traffic mix (traffic/<name>.json)
and a configuration (configs/<name>.json) and makes, from the run's seed
alone, the inputs the window sends: each batch job's perturbed columns.
Every seed gives the same sizes and the same number of columns a job;
only the drawn values differ.

Streams of one seed: 0 the window's jobs, 1 the warm-up, 2 the choice
of what the reference checks.

Frozen: later changes add traffic files, and do not edit this file.
"""

from __future__ import annotations

import numpy as np

WINDOW, WARMUP, SAMPLE = 0, 1, 2


def rng(seed: int, stream: int, index: int = 0) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream, index])


def batch_columns(config: dict, traffic: dict, seed: int, job: int,
                  stream: int = WINDOW, ncols: int | None = None) -> dict:
    """Job `job`'s columns as arrays [C] of csza, gas_scale, cld_scale,
    aer_scale and albedo_scale.  As chip_smoke.py:c5_batch lays them out:
    column k * Z + z is perturbation k at solar zenith z of Z, evenly
    spaced over traffic["zenith_deg"]; perturbation 0 is the nominal
    column (every scale 1), the others draw each scale uniformly from
    traffic["scales"].  C is config["columns"] unless `ncols` is given."""
    nz = int(config["zeniths"])
    n = int(config["columns"] if ncols is None else ncols)
    nk = -(-n // nz)
    g = rng(seed, stream, job)
    scales = {}
    for name, (lo, hi) in sorted(traffic["scales"].items()):
        v = g.uniform(lo, hi, nk)
        v[0] = 1.0
        scales[name] = np.repeat(v, nz)[:n]
    z0, z1 = traffic["zenith_deg"]
    csza = np.cos(np.deg2rad(np.linspace(z0, z1, nz)))
    return dict(csza=np.tile(csza, nk)[:n], **scales)


def _value(v) -> str:
    if isinstance(v, bool):
        return ".true." if v else ".false."
    if isinstance(v, (list, tuple)):
        return ",".join(_value(x) for x in v)
    return repr(v)


def namelist_text(values: dict) -> str:
    """An &INPUT namelist of `values`."""
    body = ",\n".join(f"   {k}={_value(v)}" for k, v in values.items())
    return f" &INPUT\n{body}\n /\n"


def sample(seed: int, population: int, k: int) -> list[int]:
    """`k` distinct indices of range(population), drawn from the seed's
    sampling stream (all of them where population <= k)."""
    if population <= k:
        return list(range(population))
    return sorted(int(i) for i in rng(seed, SAMPLE).choice(
        population, size=k, replace=False))
