#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sbdart_tpu_torch) on one GPU and check it.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one JSON line each; the first failure exits non-zero:

  1. device   the card's name and power limit (nvidia-smi);
  2. build    nvcc builds the CUDA kernels from kernels/csrc/ (timed);
  3. kernel   each kernel against its plain torch version on the card at
              the main path's shapes (33 layers x 49152 columns, and an
              unaligned 130), bar rtol 1e-4 / atol 1e-5, with both device
              times (torch.profiler) and both wall times (CUDA events);
  4. solve    solve_rte (nstr=4, float32) at 16384 band-columns x 3
              k-terms x 33 layers through the kernels, against the plain
              path on the card (max-abs error / max-abs <= 5e-4), with
              band-columns/s for both and the kernel path's device idle
              share;
  5. cli      the sbdart CLI on the BASELINE config 1 INPUT, with the
              Lambertian closure botup/botdn = albcon to 1e-5.

Kernel launch counters are zeroed just before phase 4 and read after
phase 5: each kernel must have been launched by the main path.  Then come
the kernels summary, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.  Without a CUDA device the script fails.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

NLYR = 33
NBC = 16384            # band-columns
NK = 3                 # k-terms per band-column
B = NBC * NK           # columns the kernels see
RTOL, ATOL = 1e-4, 1e-5        # kernel vs plain (tests/test_pallas_kernels.py:142)
E2E_BAR = 5e-4                 # solve vs plain path (tests/test_pallas_kernels.py:364-368)
MODE_MISS_SHARE = 1e-4         # per-mode planes: largest share of misses reported, not failed
INPUT_C1 = """ &INPUT
   idatm=2, wlinf=0.25, wlsup=2.0, wlinc=0.005,
   sza=30, albcon=0.2, nstr=4, iout=10
 /
"""


class SmokeFailure(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def timed_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median wall milliseconds of fn() over `reps` CUDA-event timings (the
    device's clock around each call: host dispatch gaps included)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def device_ms(fn, reps: int, match: str | None = None) -> float:
    """Device milliseconds per call of fn(): the summed durations of the
    CUDA work it launches (only kernels whose name holds `match`, if
    given), from torch.profiler.  Host dispatch gaps are not counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and (match is None or match in e.name)]
    if not ev:
        raise SmokeFailure(f"profiler saw no device work ({match})")
    return sum(e.time_range.elapsed_us() for e in ev) / reps / 1e3


def flux_problem(nbc, nk, nlyr, device, seed=0):
    """Batch-major solve_rte inputs with the distributions of
    tests/test_pallas_kernels.py:325-346: dtau U(0.001, 0.6), ssalb
    U(0.05, 0.999), HG moments of g U(0, 0.85), 20% of columns without a
    beam, umu0 U(0.2, 1), albedo U(0, 0.8)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    dtau = u(0.001, 0.6, nbc, nk, nlyr)
    ssalb = u(0.05, 0.999, nbc, nk, nlyr)
    g = u(0.0, 0.85, nbc, 1, nlyr)
    pmom = g[..., None] ** torch.arange(5, device=device)
    fbeam = (u(0.0, 1.0, nbc, 1) < 0.8).float()
    umu0 = u(0.2, 1.0, nbc, 1)
    albedo = u(0.0, 0.8, nbc, 1)
    return dict(dtau=dtau, ssalb=ssalb, pmom=pmom, fbeam=fbeam, umu0=umu0,
                albedo=albedo)


def kernel_operands(prob):
    """B1's and B2's operands as the main path builds them."""
    import torch

    from sbdart_tpu_torch.solver import fluxlane

    batch = prob["dtau"].shape[:-1]
    dtau, ssalb = prob["dtau"], prob["ssalb"]
    pmom = prob["pmom"].expand(batch + prob["pmom"].shape[-2:])
    fbeam, umu0, albedo = (prob[k].expand(batch)
                           for k in ("fbeam", "umu0", "albedo"))
    fisot = torch.zeros_like(fbeam)
    b1_ops, use_dm = fluxlane.front_operands(
        dtau, ssalb, pmom, fbeam=fbeam, umu0=umu0, deltam=True)
    b1_ops = tuple(x.contiguous() for x in b1_ops)
    fe = fluxlane.front_end(dtau, ssalb, pmom, fbeam=fbeam, umu0=umu0,
                            deltam=True, kernels=False)
    sysm = fluxlane.bvp_system(fe, fbeam=fbeam, fisot=fisot, albedo=albedo)
    b2_ops = (fe.gp, fe.gm, fe.ee, sysm.refl, sysm.rhs)
    return b1_ops, use_dm, fe.tab, b2_ops


def compare(name, got, want):
    """Worst error and bar misses of one output plane."""
    import torch

    if got.shape != want.shape:
        raise SmokeFailure(f"{name}: shape {tuple(got.shape)} != "
                           f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise SmokeFailure(f"{name}: kernel output not finite")
    diff = (got.double() - want.double()).abs()
    miss = diff > ATOL + RTOL * want.double().abs()
    return {
        "output": name,
        "max_abs_err": float(diff.max()),
        "misses": int(miss.sum()),
        "miss_max_abs": float(diff[miss].max()) if bool(miss.any()) else 0.0,
        "elements": got.numel(),
    }


def phase_kernels(device, reps):
    """Each kernel against its plain version at the main path's shapes."""
    from sbdart_tpu_torch.kernels.blocktri_n2 import (
        block_thomas_rt_n2, block_thomas_rt_n2_plain)
    from sbdart_tpu_torch.kernels.eig_n2 import (
        eig_beam_deltam_scatter_n2, eig_beam_deltam_scatter_n2_plain)

    summary = {}
    b1_names = ("kk", "gp", "gm", "zp", "zm", "dtau_scaled", "ee")
    for nbc, nk in ((NBC, NK), (130, 1)):
        prob = flux_problem(nbc, nk, NLYR, device)
        b1_ops, use_dm, tab, b2_ops = kernel_operands(prob)
        b = b1_ops[0].shape[-1]
        rows = []

        got = eig_beam_deltam_scatter_n2(*b1_ops, tab, use_deltam=use_dm)
        want = eig_beam_deltam_scatter_n2_plain(*b1_ops, tab,
                                                use_deltam=use_dm)
        b1 = [compare(n, g, w) for n, g, w in zip(b1_names, got, want)]
        xs = compare("xs", block_thomas_rt_n2(*b2_ops),
                     block_thomas_rt_n2_plain(*b2_ops))
        for kname, outs in (("eig_n2_deltam", b1), ("blocktri_rt_n2", [xs])):
            for o in outs:
                share = o["misses"] / o["elements"]
                # dtau* is mode-free: any miss there is a kernel fault.
                # Per-mode planes may miss at near-degenerate lanes only;
                # they are reported and the solve phase decides.
                if o["misses"] and (o["output"] == "dtau_scaled"
                                    or share > MODE_MISS_SHARE):
                    raise SmokeFailure(f"{kname}/{o['output']} at B={b}: "
                                       f"{o['misses']} misses of the bar")
            rows.append({"kernel": kname, "outputs": outs})
        if b == B:
            # ms / plain_ms: device time (profiler); the wall figures add
            # the host's dispatch gaps (CUDA events around each call)
            calls = {
                "eig_n2_deltam": (
                    lambda: eig_beam_deltam_scatter_n2(
                        *b1_ops, tab, use_deltam=use_dm),
                    lambda: eig_beam_deltam_scatter_n2_plain(
                        *b1_ops, tab, use_deltam=use_dm), reps),
                "blocktri_rt_n2": (
                    lambda: block_thomas_rt_n2(*b2_ops),
                    lambda: block_thomas_rt_n2_plain(*b2_ops),
                    max(3, reps // 4)),
            }
            for row in rows:
                kern, plain, n = calls[row["kernel"]]
                row.update(
                    ms=device_ms(kern, reps, match=row["kernel"]),
                    plain_ms=device_ms(plain, n),
                    wall_ms=timed_ms(kern, reps),
                    plain_wall_ms=timed_ms(plain, n, warmup=1),
                )
                summary[row["kernel"]] = {
                    "max_abs_err": max(o["max_abs_err"]
                                       for o in row["outputs"]),
                    "ms": row["ms"], "plain_ms": row["plain_ms"],
                }
        emit({"phase": "kernel", "layers": NLYR, "columns": b,
              "bar": {"rtol": RTOL, "atol": ATOL}, "results": rows})
    return summary


def phase_solve(device, reps):
    """solve_rte through the kernels against the plain path, timed."""
    import torch

    from sbdart_tpu_torch.solver.disort import solve_rte

    prob = flux_problem(NBC, NK, NLYR, device)
    kw = dict(nstr=4, fbeam=prob["fbeam"], umu0=prob["umu0"],
              albedo=prob["albedo"], onlyfl=True, dtype=torch.float32)
    args = (prob["dtau"], prob["ssalb"], prob["pmom"])

    def run(method):
        return solve_rte(*args, eig_method=method, **kw)

    out_k = run("auto")
    out_p = run("plain")
    errs = {}
    for name in ("rfldir", "rfldn", "flup", "uavg", "dfdt"):
        a, b = getattr(out_k, name), getattr(out_p, name)
        if tuple(a.shape) != (NBC, NK, NLYR + 1):
            raise SmokeFailure(f"solve {name}: shape {tuple(a.shape)}")
        if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
            raise SmokeFailure(f"solve {name}: non-finite output")
        errs[name] = float((a - b).abs().max() / b.abs().max().clamp_min(1e-9))
    worst = max(errs[n] for n in ("rfldn", "flup", "uavg", "dfdt"))
    k_ms = timed_ms(lambda: run("auto"), reps)
    p_ms = timed_ms(lambda: run("plain"), max(3, reps // 2), warmup=1)
    busy_ms = device_ms(lambda: run("auto"), reps)
    rec = {"phase": "solve", "band_columns": NBC, "k_terms": NK,
           "layers": NLYR, "dtype": "float32", "rel_err": errs,
           "bar": E2E_BAR, "kernel_path_ms": k_ms, "plain_path_ms": p_ms,
           "kernel_path_bc_per_s": NBC / (k_ms / 1e3),
           "plain_path_bc_per_s": NBC / (p_ms / 1e3),
           "kernel_path_device_busy_ms": busy_ms,
           "kernel_path_device_idle_share": max(0.0, 1.0 - busy_ms / k_ms)}
    emit(rec)
    if worst > E2E_BAR:
        raise SmokeFailure(f"solve: kernel vs plain path {worst:.3g} > "
                           f"{E2E_BAR}")
    return rec


def phase_cli():
    """The sbdart CLI on BASELINE config 1, and the surface closure."""
    from sbdart_tpu_torch import cli
    from sbdart_tpu_torch.api import run
    from sbdart_tpu_torch.namelist import load_namelist
    from sbdart_tpu_torch.outputs import (
        format_iout, integrate_spectral, summary_fluxes)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "INPUT")
        with open(path, "w") as fh:
            fh.write(INPUT_C1)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([path])
        cli_s = time.perf_counter() - t0
        cfg = load_namelist(path).validate()
    text = buf.getvalue()
    if rc != 0:
        raise SmokeFailure(f"cli returned {rc}")
    vals = [float(v) for v in text.split()]
    if len(vals) != 9 or not all(math.isfinite(v) for v in vals):
        raise SmokeFailure(f"cli: unexpected iout=10 line {text!r}")
    _, _, _, topdn, topup, _, botdn, botup, _ = vals
    if not 0.0 < topup / topdn < 1.0:
        raise SmokeFailure(f"cli: topup/topdn = {topup / topdn}")

    res = run(cfg)
    if format_iout(res) != text:
        raise SmokeFailure("cli: text differs from api.run's")
    s = summary_fluxes(res)
    closure = (integrate_spectral(res, s["botup"])
               / integrate_spectral(res, s["botdn"]))
    rec = {"phase": "cli", "input": "BASELINE config 1", "iout10": text.strip(),
           "wavelengths": int(len(res.wl)), "seconds": cli_s,
           "topup_over_topdn": topup / topdn,
           "botup_over_botdn": closure, "albcon": cfg.albcon}
    emit(rec)
    if abs(closure - cfg.albcon) > 1e-5:
        raise SmokeFailure(f"cli: botup/botdn = {closure} != albcon")
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this script runs the port on "
                           "the card and has no CPU mode")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    from sbdart_tpu_torch.kernels import _build
    from sbdart_tpu_torch.kernels.blocktri_n2 import block_thomas_rt_n2
    from sbdart_tpu_torch.kernels.eig_n2 import eig_beam_deltam_scatter_n2

    path, build_s = _build.build()
    _build.library()
    log = (path.parent / "build.log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.exists() else []
    emit({"phase": "build", "seconds": build_s, "library": path.name,
          "ptxas": ptxas})

    summary = phase_kernels(device, reps=20)

    wrappers = {"eig_n2_deltam": eig_beam_deltam_scatter_n2,
                "blocktri_rt_n2": block_thomas_rt_n2}
    for fn in wrappers.values():
        fn.launches = 0
    phase_solve(device, reps=10)
    phase_cli()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    if not all(launches.values()):
        raise SmokeFailure(f"main path skipped a kernel: {launches}")

    meta = {
        "eig_n2_deltam": ("sbdart_tpu_torch/kernels/csrc/eig_n2_deltam.cu",
                          "sbdart_tpu/pallas/eig.py:838"),
        "blocktri_rt_n2": ("sbdart_tpu_torch/kernels/csrc/blocktri_rt_n2.cu",
                           "sbdart_tpu/pallas/blocktri.py:823"),
    }
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": meta[k][0],
         "replaces": meta[k][1], "launches": launches[k], **summary[k]}
        for k in wrappers
    ]})
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
