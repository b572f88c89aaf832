"""The least time each operation of a solve needs on the card, counted
from the cell's problem shapes.

A frozen copy of chip_smoke.py's `flops_of` and `bound_of` (the bytes of
each input read once and each output written once, the operations from
the formulas of the kernel that does the work as that kernel stood when
this benchmark was written) and of its peaks, keyed by operation instead
of by kernel, so that the work a share divides reads the same whatever
kernel a later change runs for it:

  eig     the per-layer eigen front end (with the beam's particular
          solution): B3 at nstr = 4 with the thermal source, B4 at
          N = 4, 6, 8 (layered for fluxes, on the flat lane axis of all
          azimuth modes for radiances);
  bvp     the boundary-value solve: B2 at N = 2, B5 at N >= 3 where the
          reference does not stream the layers;
  radsrc  the radiance source projection at the user cosines (B7).

A shape that none of these formulas covers gives None, and the reader
then reports nothing.  Later changes do not edit this file.
"""

from __future__ import annotations

# the card's peaks (NVIDIA H100 SXM data sheet, at its 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
F32 = 4
SWEEPS_F32 = 3          # Jacobi sweeps of the float32 eigen kernels


def _ge_flops(m, r):
    """Operations of a pivoted elimination of an m x m system with r
    right-hand sides, back-substitution included."""
    return 2.0 * m**3 / 3.0 + 2.0 * m * m * r


def _streams(nlyr: int, n: int) -> bool:
    """Whether the reference streams the BVP's layers (B6) at this shape
    (kernels/blocktri_rt_streamed.py:reference_streams)."""
    return {8: 42, 6: 71, 4: 147}.get(n, 10**9) <= nlyr


def eig(s: dict):
    """(bytes, operations) of one solve's eigen front end, or None."""
    n, nlyr, cols = s["nstr"] // 2, s["layers"], s["columns"]
    if n == 2 and s["planck"] and s["modes"] == 1:
        lanes = nlyr * cols
        return F32 * (19 * lanes + 2 * cols), 230 * lanes
    if n in (4, 6, 8):
        if s["modes"] > 1:          # flat: one layer of modes x layers x cols
            lanes, beams = s["modes"] * nlyr * cols, s["modes"] * nlyr * cols
        else:
            lanes, beams = nlyr * cols, cols
        per = (n**3 / 3 + SWEEPS_F32 * (n * (n - 1) / 2) * 12 * n
               + 5 * n**3 + 2 * n**3 + _ge_flops(n, 1))
        nbytes = F32 * (lanes * (4 * n * n + 5 * n) + beams)
        return nbytes, lanes * per
    return None


def bvp(s: dict):
    """(bytes, operations) of one solve's boundary-value problem, or
    None."""
    n, nlyr = s["nstr"] // 2, s["layers"]
    b = s["columns"] * s["modes"]
    m = 2 * n
    if n == 2:
        per = _ge_flops(m, m + 1) + 2 * n * m * (m + 1) + 2 * m * m
        return F32 * (18 * nlyr * b + 4 * b), b * (nlyr * per + 4 * n**3)
    if n >= 3 and not _streams(nlyr, n):
        per = _ge_flops(m, m + 1) + 2 * n * m * (m + 1) + 2 * m * m
        nbytes = F32 * (nlyr * b * (2 * n * n + 5 * n) + n * n * b)
        return nbytes, b * (nlyr * per + 4 * n**3)
    return None


def radsrc(s: dict):
    """(bytes, operations) of one solve's source projection at the user
    cosines, or None without them."""
    nu = s["umu"]
    if not nu or s["modes"] == 1:
        return None
    m, n, nstr = s["modes"], s["nstr"] // 2, s["nstr"]
    lb = s["layers"] * s["columns"]
    nbytes = F32 * (2 * m * nu * n * nstr + m * nu * nstr + m * lb
                    + m * nstr * lb + 2 * m * n * n * lb + 5 * m * n * lb
                    + 4 * lb + m * nu * lb)
    per = 4 * n * nstr + 8 * n * n + 4 * n + 3 * nstr + 40 * n + 30
    return nbytes, m * nu * lb * per


OPERATIONS = {"eig": eig, "bvp": bvp, "radsrc": radsrc}


def least_seconds(op: str, shapes: dict) -> float | None:
    """The larger of one solve's bytes over the card's bandwidth and its
    operations over its float32 rate, for operation `op`; None where the
    formulas do not cover the shape."""
    w = OPERATIONS[op](shapes)
    if w is None:
        return None
    nbytes, flops = w
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def roofline_share(op: str, obs, patterns) -> float | None:
    """A traced span's share of the roofline for `op`, in percent: the
    least time of the solves the span ran (their count from the cell's
    shapes) over the device time of the kernels whose names match one of
    `patterns` (regular expressions); None where nothing was traced, no
    such kernel ran, or the shape is not covered."""
    import re

    if obs.trace is None:
        return None
    t = least_seconds(op, obs.shapes)
    ns = obs.trace.device_ns(
        lambda name: any(re.search(p, name) for p in patterns))
    if t is None or ns <= 0:
        return None
    return 100.0 * t * obs.solves_traced / (ns / 1e9)
