#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sbdart_tpu_torch) on one GPU and check it.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one JSON line each; the first failure exits non-zero:

  1. device   the card's name and power limit (nvidia-smi);
  2. build    nvcc builds the CUDA kernels from kernels/csrc/ (timed);
  3. kernel   each kernel against its plain torch version on the card at
              the main path's shapes, bar rtol 1e-4 / atol 1e-5 on every
              element of every output, with both device times
              (torch.profiler) and both wall times (CUDA events): B1/B2 at
              33 layers x 49152 columns, B3 (nstr=4 thermal front end) at
              33 x 49152, B4 with the BVP kernels B5 (full-W history) and
              B6 (rank-N history, forward and backward) at nstr 16 x 65
              layers and nstr 8 x 33 layers x 6144 columns (the path runs
              B6 at the first and B5 at the second; both are timed at
              both), each also at an unaligned 130 columns;
  4. solve    solve_rte in float32 through the kernels against the plain
              path on the card (max-abs error / max-abs <= 5e-4), with
              band-columns/s for both, and the kernel path's device time
              split into each kernel and the glue, its device operations
              per solve and its idle share: nstr=4 solar at 16384
              band-columns x 3 k-terms x 33 layers, nstr=16 solar at
              2048 x 3 x 65 (B4, B6), nstr=4 thermal at 16384 x 3 x 33;
  5. cli      the sbdart CLI on BASELINE config 1 (Lambertian closure
              botup/botdn = albcon to 1e-5), config 2 (tropical LW, 4-40 um,
              nstr=4: OLR finite, positive, and within 1e-2 of the float64
              plain route on the card) and config 3 (water cloud, nstr=16,
              SW+LW, 32 layers, so B4 and B5: iout=10 line finite; closure on
              its solar-only part).

Kernel launch counters are zeroed just before each run of phases 4 and
5 and read just after it: each kernel must have been launched by the runs
whose path holds it.  Then come the kernels summary, the nvidia-smi line,
and as the last line {"ok": true, "device": {...}}.  Without a CUDA
device the script fails.
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
INPUT_C1 = """ &INPUT
   idatm=2, wlinf=0.25, wlsup=2.0, wlinc=0.005,
   sza=30, albcon=0.2, nstr=4, iout=10
 /
"""
# BASELINE config 2: tropical LW fluxes and heating rates, 4-40 um
INPUT_C2 = """ &INPUT
   idatm=1, wlinf=4.0, wlsup=40.0, wlinc=-20.0,
   nstr=4, sza=95, iout=11
 /
"""
# BASELINE config 3: water cloud, 16 streams, SW+LW broadband fluxes, on a
# 20 cm^-1 grid; its solar-only part (to 2 um) checks the surface closure
INPUT_C3 = """ &INPUT
   idatm=2, wlinf={wlinf}, wlsup={wlsup}, wlinc=-20.0,
   zcloud=2, tcloud=10, nre=10, sza=30, albcon=0.2, nstr=16, iout=10
 /
"""
# bench.py:_throughput(nstr=16, nlyr=65, nbc=2048)
NLYR16, NBC16 = 65, 2048
B16 = NBC16 * NK               # columns the nstr=16 kernels see
OLR_BAR = 1e-2                 # f32 kernel path vs f64 plain route


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


def device_events(fn, reps: int):
    """The device operations (kernels, copies, fills) of `reps` calls of
    fn(), from torch.profiler, as (name, microseconds) pairs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(fn, reps: int, match: str | None = None) -> float:
    """Device milliseconds per call of fn(): the summed durations of the
    CUDA work it launches (only kernels whose name holds `match`, if
    given).  Host dispatch gaps are not counted."""
    us = [t for name, t in device_events(fn, reps)
          if match is None or match in name]
    if not us:
        raise SmokeFailure(f"profiler saw no device work ({match})")
    return sum(us) / reps / 1e3


def device_breakdown(fn, reps: int) -> dict:
    """Per call of fn(): device ms in all, in each of the port's kernels
    (by its __global__ name) and in the rest (the torch glue), and the
    number of device operations."""
    ev = device_events(fn, reps)
    if not ev:
        raise SmokeFailure("profiler saw no device work")
    busy = sum(t for _, t in ev) / reps / 1e3
    per = {}
    for k, spec in KERNELS.items():
        us = [t for name, t in ev if spec[4] in name]
        if us:
            per[k] = sum(us) / reps / 1e3
    return {"device_busy_ms": busy, "kernel_device_ms": per,
            "glue_device_ms": busy - sum(per.values()),
            "device_ops_per_solve": len(ev) / reps}


def flux_problem(nbc, nk, nlyr, device, seed=0, nmom=5, planck=False):
    """Batch-major solve_rte inputs with the distributions of
    tests/test_pallas_kernels.py:325-346: dtau U(0.001, 0.6), ssalb
    U(0.05, 0.999), HG moments of g U(0, 0.85), 20% of columns without a
    beam, umu0 U(0.2, 1), albedo U(0, 0.8); with `planck`, its thermal
    case: temperatures 250-290 K down the column, the 800-900 cm^-1 band,
    btemp 290 K and isotropic top illumination 0.3."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    dtau = u(0.001, 0.6, nbc, nk, nlyr)
    ssalb = u(0.05, 0.999, nbc, nk, nlyr)
    g = u(0.0, 0.85, nbc, 1, nlyr)
    pmom = g[..., None] ** torch.arange(nmom, device=device)
    fbeam = (u(0.0, 1.0, nbc, 1) < 0.8).float()
    umu0 = u(0.2, 1.0, nbc, 1)
    albedo = u(0.0, 0.8, nbc, 1)
    prob = dict(dtau=dtau, ssalb=ssalb, pmom=pmom, fbeam=fbeam, umu0=umu0,
                albedo=albedo)
    if planck:
        prob.update(planck=True, wvnlo=800.0, wvnhi=900.0, btemp=290.0,
                    fisot=0.3, temper=torch.linspace(
                        250.0, 290.0, nlyr + 1, device=device))
    return prob


def lane_inputs(prob):
    """solve_rte's broadcast of a flux_problem: (dtau, ssalb, pmom) and the
    keyword inputs of the lane path, batch-major, with PlanckInputs (or
    None)."""
    import torch

    from sbdart_tpu_torch.solver.fluxlane import PlanckInputs

    batch = prob["dtau"].shape[:-1]
    nlyr = prob["dtau"].shape[-1]
    pmom = prob["pmom"].expand(batch + prob["pmom"].shape[-2:])
    kw = {k: prob[k].expand(batch) for k in ("fbeam", "umu0", "albedo")}
    kw["fisot"] = torch.full_like(kw["fbeam"], prob.get("fisot", 0.0))
    pk = None
    if prob.get("planck"):
        full = {k: torch.full_like(kw["fbeam"], prob[k])
                for k in ("wvnlo", "wvnhi", "btemp")}
        pk = PlanckInputs(prob["temper"].expand(batch + (nlyr + 1,)),
                          full["wvnlo"], full["wvnhi"], full["btemp"],
                          torch.zeros_like(kw["fbeam"]),
                          torch.zeros_like(kw["fbeam"]))
    return (prob["dtau"], prob["ssalb"], pmom), kw, pk


def kernel_operands(prob):
    """B1's and B2's operands as the main path builds them."""
    from sbdart_tpu_torch.solver import fluxlane

    args, kw, _ = lane_inputs(prob)
    b1_ops, use_dm = fluxlane.front_operands(
        *args, fbeam=kw["fbeam"], umu0=kw["umu0"], deltam=True)
    b1_ops = tuple(x.contiguous() for x in b1_ops)
    fe = fluxlane.front_end(*args, fbeam=kw["fbeam"], umu0=kw["umu0"],
                            deltam=True, kernels=False)
    sysm = fluxlane.bvp_system(fe, fbeam=kw["fbeam"], fisot=kw["fisot"],
                               albedo=kw["albedo"])
    b2_ops = (fe.gp, fe.gm, fe.ee, sysm.refl, sysm.rhs)
    return b1_ops, use_dm, fe.tab, b2_ops


def general_kernel_operands(prob, nstr):
    """The front-end kernel's operands (B3 at nstr=4 with Planck, B4 at
    nstr >= 8, the tables appended) and the BVP kernel's (B2 or B5), as
    the main path builds them."""
    from sbdart_tpu_torch.solver import fluxlane

    args, kw, pk = lane_inputs(prob)
    fe = fluxlane.front_end(*args, fbeam=kw["fbeam"], umu0=kw["umu0"],
                            deltam=True, kernels=False, nstr=nstr,
                            planck=pk is not None)
    _, mu0, scale_row, mu0_row = fluxlane.beam_rows(kw["fbeam"], kw["umu0"])
    if nstr == 4:
        front = fluxlane.scatter_operands(fe.dm, scale_row, mu0_row)
        extra = (fe.tab,)
    else:
        front = fluxlane.general_operands(fe.dm, fe.tab, mu0, scale_row)
        extra = (fe.tab.mu, fe.tab.w)
    sysm = fluxlane.bvp_system(fe, fbeam=kw["fbeam"], fisot=kw["fisot"],
                               albedo=kw["albedo"], planck=pk)
    front = tuple(x.contiguous() for x in front) + extra
    return front, (fe.gp, fe.gm, fe.ee, sysm.refl, sysm.rhs)


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


def check_kernel(kname, names, kern, plain, b):
    """One kernel against its plain version on the same operands: a row
    of per-output comparisons.  The kernel follows its plain version's
    operation order on the same inputs, eigenmode order included, so any
    element outside the bar fails."""
    got, want = kern(), plain()
    if not isinstance(got, (tuple, list)):
        got, want = (got,), (want,)
    outs = [compare(n, g, w) for n, g, w in zip(names, got, want)]
    for o in outs:
        if o["misses"]:
            raise SmokeFailure(f"{kname}/{o['output']} at B={b}: "
                               f"{o['misses']} misses of the bar")
    return {"kernel": kname, "outputs": outs}


def time_kernel(row, kern, plain, reps, plain_reps):
    """ms / plain_ms: device time (profiler, the kernel's own launches);
    the wall figures add the host's dispatch gaps (CUDA events)."""
    row.update(
        ms=device_ms(kern, reps, match=KERNELS[row["kernel"]][4]),
        plain_ms=device_ms(plain, plain_reps),
        wall_ms=timed_ms(kern, reps),
        plain_wall_ms=timed_ms(plain, plain_reps, warmup=1),
    )


def fold(summary, row, main):
    """Fold a checked row into the kernels summary: the largest error over
    every shape checked, and the times of the main shape."""
    entry = summary.setdefault(row["kernel"], {"max_abs_err": 0.0})
    entry["max_abs_err"] = max(entry["max_abs_err"],
                               *(o["max_abs_err"] for o in row["outputs"]))
    if main:
        entry.update(ms=row["ms"], plain_ms=row["plain_ms"])


EIG_NAMES = ("kk", "gp", "gm", "zp", "zm")


def phase_kernels(device, reps):
    """B1 and B2 against their plain versions at the main path's shapes."""
    from sbdart_tpu_torch.kernels.blocktri_n2 import (
        block_thomas_rt_n2, block_thomas_rt_n2_plain)
    from sbdart_tpu_torch.kernels.eig_n2 import (
        eig_beam_deltam_scatter_n2, eig_beam_deltam_scatter_n2_plain)

    summary = {}
    b1_names = EIG_NAMES + ("dtau_scaled", "ee")
    for nbc, nk in ((NBC, NK), (130, 1)):
        prob = flux_problem(nbc, nk, NLYR, device)
        b1_ops, use_dm, tab, b2_ops = kernel_operands(prob)
        b = b1_ops[0].shape[-1]
        calls = {
            "eig_n2_deltam": (
                b1_names,
                lambda: eig_beam_deltam_scatter_n2(
                    *b1_ops, tab, use_deltam=use_dm),
                lambda: eig_beam_deltam_scatter_n2_plain(
                    *b1_ops, tab, use_deltam=use_dm), reps),
            "blocktri_rt_n2": (
                ("xs",), lambda: block_thomas_rt_n2(*b2_ops),
                lambda: block_thomas_rt_n2_plain(*b2_ops),
                max(3, reps // 4)),
        }
        rows = []
        for kname, (names, kern, plain, plain_reps) in calls.items():
            row = check_kernel(kname, names, kern, plain, b)
            if b == B:
                time_kernel(row, kern, plain, reps, plain_reps)
            fold(summary, row, main=b == B)
            rows.append(row)
        emit({"phase": "kernel", "layers": NLYR, "columns": b,
              "bar": {"rtol": RTOL, "atol": ATOL}, "results": rows})
    return summary


def phase_kernels_general(device, reps):
    """B3 (nstr=4 thermal front end), B4, B5 and B6 (nstr 16 and 8)
    against their plain versions at the main path's shapes and at 130
    columns.  B6's backward kernel is held against its plain version on
    the plain forward's history."""
    from sbdart_tpu_torch.kernels.blocktri_rt import (
        block_thomas_rt, block_thomas_rt_plain)
    from sbdart_tpu_torch.kernels.blocktri_rt_streamed import (
        block_thomas_rt_bwd, block_thomas_rt_bwd_plain, block_thomas_rt_fwd,
        block_thomas_rt_fwd_plain, reference_streams)
    from sbdart_tpu_torch.kernels.eig_beam import (
        eig_beam_chain, eig_beam_chain_plain)
    from sbdart_tpu_torch.kernels.eig_n2_scatter import (
        eig_beam_scatter_n2, eig_beam_scatter_n2_plain)

    summary = {}
    # (nstr, layers, columns)
    cases = [(4, NLYR, NBC), (16, NLYR16, NBC16), (8, NLYR, NBC16)]
    # the nstr whose shape gives each kernel's times in the summary: one
    # where the main path runs it
    summary_nstr = {"eig_n2_scatter": 4, "eig_beam": 16, "blocktri_rt": 8,
                    "blocktri_rt_fwd": 16, "blocktri_rt_bwd": 16}
    for nstr, nlyr, nbc in cases:
        for cols, nk in ((nbc, NK), (130, 1)):
            prob = flux_problem(cols, nk, nlyr, device, nmom=nstr + 1,
                                planck=nstr == 4)
            front, bvp = general_kernel_operands(prob, nstr)
            b = bvp[0].shape[-1]
            if nstr == 4:
                calls = {"eig_n2_scatter": (
                    EIG_NAMES, lambda: eig_beam_scatter_n2(*front),
                    lambda: eig_beam_scatter_n2_plain(*front), reps)}
            else:
                hist = block_thomas_rt_fwd_plain(*bvp)
                calls = {
                    "eig_beam": (
                        EIG_NAMES, lambda: eig_beam_chain(*front),
                        lambda: eig_beam_chain_plain(*front),
                        max(3, reps // 4)),
                    "blocktri_rt": (
                        ("xs",), lambda: block_thomas_rt(*bvp),
                        lambda: block_thomas_rt_plain(*bvp), 2),
                    "blocktri_rt_fwd": (
                        ("cs", "ys"), lambda: block_thomas_rt_fwd(*bvp),
                        lambda: block_thomas_rt_fwd_plain(*bvp), 2),
                    "blocktri_rt_bwd": (
                        ("xs",), lambda: block_thomas_rt_bwd(*bvp[:3], *hist),
                        lambda: block_thomas_rt_bwd_plain(*bvp[:3], *hist),
                        3),
                }
            streams = nstr > 4 and reference_streams(nlyr, nstr // 2)
            rows = []
            for kname, (names, kern, plain, plain_reps) in calls.items():
                row = check_kernel(kname, names, kern, plain, b)
                if cols == nbc:
                    time_kernel(row, kern, plain, reps, plain_reps)
                row["on_main_path"] = (
                    kname in ("eig_beam", "eig_n2_scatter")
                    or (kname != "blocktri_rt") == streams)
                fold(summary, row,
                     main=summary_nstr[kname] == nstr and cols == nbc)
                rows.append(row)
            emit({"phase": "kernel", "nstr": nstr, "layers": nlyr,
                  "columns": b, "bar": {"rtol": RTOL, "atol": ATOL},
                  "results": rows})
    return summary


def phase_solve(device, reps, *, nstr=4, nbc=NBC, nlyr=NLYR, planck=False):
    """solve_rte through the kernels against the plain path, timed."""
    import torch

    from sbdart_tpu_torch.solver.disort import solve_rte

    prob = flux_problem(nbc, NK, nlyr, device, nmom=nstr + 1, planck=planck)
    args = (prob.pop("dtau"), prob.pop("ssalb"), prob.pop("pmom"))
    kw = dict(nstr=nstr, onlyfl=True, dtype=torch.float32, **prob)

    def run(method):
        return solve_rte(*args, eig_method=method, **kw)

    out_k = run("auto")
    out_p = run("plain")
    errs = {}
    for name in ("rfldir", "rfldn", "flup", "uavg", "dfdt"):
        a, b = getattr(out_k, name), getattr(out_p, name)
        if tuple(a.shape) != (nbc, NK, nlyr + 1):
            raise SmokeFailure(f"solve {name}: shape {tuple(a.shape)}")
        if not (bool(torch.isfinite(a).all())
                and bool(torch.isfinite(b).all())):
            raise SmokeFailure(f"solve {name}: non-finite output")
        errs[name] = float((a - b).abs().max() / b.abs().max().clamp_min(1e-9))
    worst = max(errs[n] for n in ("rfldn", "flup", "uavg", "dfdt"))
    k_ms = timed_ms(lambda: run("auto"), reps)
    p_ms = timed_ms(lambda: run("plain"), max(3, reps // 2), warmup=1)
    dev = device_breakdown(lambda: run("auto"), reps)
    busy_ms = dev["device_busy_ms"]
    rec = {"phase": "solve", "nstr": nstr, "planck": planck,
           "band_columns": nbc, "k_terms": NK,
           "layers": nlyr, "dtype": "float32", "rel_err": errs,
           "bar": E2E_BAR, "kernel_path_ms": k_ms, "plain_path_ms": p_ms,
           "kernel_path_bc_per_s": nbc / (k_ms / 1e3),
           "plain_path_bc_per_s": nbc / (p_ms / 1e3),
           "kernel_path_device_busy_ms": busy_ms,
           "kernel_path_device_idle_share": max(0.0, 1.0 - busy_ms / k_ms),
           "kernel_path_kernel_device_ms": dev["kernel_device_ms"],
           "kernel_path_glue_device_ms": dev["glue_device_ms"],
           "kernel_path_device_ops": dev["device_ops_per_solve"]}
    emit(rec)
    if worst > E2E_BAR:
        raise SmokeFailure(f"solve nstr={nstr} planck={planck}: kernel vs "
                           f"plain path {worst:.3g} > {E2E_BAR}")
    return rec


def run_cli(text):
    """cli.main on an INPUT file holding `text`: (config, stdout, seconds)."""
    from sbdart_tpu_torch import cli
    from sbdart_tpu_torch.namelist import load_namelist

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "INPUT")
        with open(path, "w") as fh:
            fh.write(text)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([path])
        seconds = time.perf_counter() - t0
        cfg = load_namelist(path).validate()
    if rc != 0:
        raise SmokeFailure(f"cli returned {rc}")
    return cfg, buf.getvalue(), seconds


def iout10_values(text, what):
    vals = [float(v) for v in text.split()]
    if len(vals) != 9 or not all(math.isfinite(v) for v in vals):
        raise SmokeFailure(f"{what}: unexpected iout=10 line {text!r}")
    return vals


def closure(res):
    """botup / botdn, spectrally integrated."""
    from sbdart_tpu_torch.outputs import integrate_spectral, summary_fluxes

    s = summary_fluxes(res)
    return (integrate_spectral(res, s["botup"])
            / integrate_spectral(res, s["botdn"]))


def phase_cli():
    """The sbdart CLI on BASELINE config 1, and the surface closure."""
    from sbdart_tpu_torch.api import run
    from sbdart_tpu_torch.outputs import format_iout

    cfg, text, cli_s = run_cli(INPUT_C1)
    _, _, _, topdn, topup, _, _, _, _ = iout10_values(text, "cli config 1")
    if not 0.0 < topup / topdn < 1.0:
        raise SmokeFailure(f"cli: topup/topdn = {topup / topdn}")
    res = run(cfg)
    if format_iout(res) != text:
        raise SmokeFailure("cli: text differs from api.run's")
    ratio = closure(res)
    rec = {"phase": "cli", "input": "BASELINE config 1",
           "iout10": text.strip(),
           "wavelengths": int(len(res.wl)), "seconds": cli_s,
           "topup_over_topdn": topup / topdn,
           "botup_over_botdn": ratio, "albcon": cfg.albcon}
    emit(rec)
    if abs(ratio - cfg.albcon) > 1e-5:
        raise SmokeFailure(f"cli: botup/botdn = {ratio} != albcon")
    return rec


def phase_cli_config2():
    """BASELINE config 2 (tropical LW, nstr=4, thermal source on): the
    iout=11 profile is finite and the OLR agrees with the float64 plain
    route on the card."""
    from sbdart_tpu_torch.api import run
    from sbdart_tpu_torch.outputs import (
        format_iout, integrate_spectral, summary_fluxes)

    cfg, text, cli_s = run_cli(INPUT_C2)
    vals = [float(v) for ln in text.splitlines() if not ln.startswith('"')
            for v in ln.split()]
    if not vals or not all(math.isfinite(v) for v in vals):
        raise SmokeFailure("cli config 2: non-finite iout=11 output")
    res = run(cfg)
    if format_iout(res) != text:
        raise SmokeFailure("cli config 2: text differs from api.run's")
    t0 = time.perf_counter()
    res64 = run(cfg, dtype="float64")
    f64_s = time.perf_counter() - t0

    def olr(r):
        return float(integrate_spectral(r, summary_fluxes(r)["topup"]))

    o32, o64 = olr(res), olr(res64)
    rec = {"phase": "cli", "input": "BASELINE config 2",
           "wavelengths": int(len(res.wl)), "seconds": cli_s,
           "olr_w_m2": o32, "olr_f64_plain_w_m2": o64,
           "olr_rel_err": abs(o32 - o64) / abs(o64), "bar": OLR_BAR,
           "f64_plain_seconds": f64_s,
           "iout11_head": text.splitlines()[:3]}
    emit(rec)
    if not (math.isfinite(o32) and o32 > 0.0):
        raise SmokeFailure(f"cli config 2: OLR {o32}")
    if rec["olr_rel_err"] > OLR_BAR:
        raise SmokeFailure(f"cli config 2: OLR {o32} vs float64 {o64}")
    return rec


def phase_cli_config3():
    """BASELINE config 3 (water cloud, nstr=16, SW+LW): the iout=10 line is
    finite; on its solar-only part the surface closure holds."""
    from sbdart_tpu_torch.api import run
    from sbdart_tpu_torch.namelist import loads_namelist
    from sbdart_tpu_torch.outputs import format_iout
    from sbdart_tpu_torch.solar import spectral_grid

    cfg, text, cli_s = run_cli(INPUT_C3.format(wlinf=0.25, wlsup=40.0))
    vals = iout10_values(text, "cli config 3")
    t0 = time.perf_counter()
    res_sw = run(loads_namelist(INPUT_C3.format(wlinf=0.25, wlsup=2.0)))
    sw_s = time.perf_counter() - t0
    text_sw = format_iout(res_sw)
    iout10_values(text_sw, "cli config 3 (solar part)")
    ratio = closure(res_sw)
    rec = {"phase": "cli", "input": "BASELINE config 3",
           "iout10": text.strip(),
           "wavelengths": len(spectral_grid(cfg)), "seconds": cli_s,
           "topup_w_m2": vals[4], "solar_part_iout10": text_sw.strip(),
           "solar_part_seconds": sw_s,
           "solar_part_botup_over_botdn": ratio, "albcon": cfg.albcon}
    emit(rec)
    if abs(ratio - cfg.albcon) > 1e-5:
        raise SmokeFailure(f"cli config 3: botup/botdn = {ratio} != albcon")
    return rec


KERNELS = {   # name: (wrapper module, wrapper, source, the TPU kernel,
              #        the CUDA kernel's __global__ name)
    "eig_n2_deltam": ("eig_n2", "eig_beam_deltam_scatter_n2",
                      "eig_n2_deltam.cu", "sbdart_tpu/pallas/eig.py:838",
                      "eig_n2_deltam_kernel"),
    "blocktri_rt_n2": ("blocktri_n2", "block_thomas_rt_n2",
                       "blocktri_rt_n2.cu",
                       "sbdart_tpu/pallas/blocktri.py:823",
                       "blocktri_rt_n2_kernel"),
    "eig_n2_scatter": ("eig_n2_scatter", "eig_beam_scatter_n2",
                       "eig_n2_scatter.cu", "sbdart_tpu/pallas/eig.py:780",
                       "eig_n2_scatter_kernel"),
    "eig_beam": ("eig_beam", "eig_beam_chain", "eig_beam.cu",
                 "sbdart_tpu/pallas/eig.py:281", "eig_beam_kernel"),
    "blocktri_rt": ("blocktri_rt", "block_thomas_rt", "blocktri_rt.cu",
                    "sbdart_tpu/pallas/blocktri.py:269",
                    "blocktri_rt_kernel"),
    "blocktri_rt_fwd": ("blocktri_rt_streamed", "block_thomas_rt_fwd",
                        "blocktri_rt_streamed.cu",
                        "sbdart_tpu/pallas/blocktri.py:373",
                        "blocktri_rt_fwd_kernel"),
    "blocktri_rt_bwd": ("blocktri_rt_streamed", "block_thomas_rt_bwd",
                        "blocktri_rt_streamed.cu",
                        "sbdart_tpu/pallas/blocktri.py:457",
                        "blocktri_rt_bwd_kernel"),
}


def main() -> int:
    import importlib

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

    path, build_s = _build.build()
    _build.library()
    log = (path.parent / "build.log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln
             ] if log.exists() else []
    emit({"phase": "build", "seconds": build_s, "library": path.name,
          "ptxas": ptxas})

    summary = phase_kernels(device, reps=20)
    summary.update(phase_kernels_general(device, reps=20))

    wrappers = {
        k: getattr(importlib.import_module(f"sbdart_tpu_torch.kernels.{m}"), f)
        for k, (m, f, _, _, _) in KERNELS.items()
    }
    owners = [   # each phase of the main path and the kernels it runs
        (lambda: phase_solve(device, reps=10),
         ("eig_n2_deltam", "blocktri_rt_n2")),
        (lambda: phase_solve(device, reps=10, nstr=16, nbc=NBC16,
                             nlyr=NLYR16),
         ("eig_beam", "blocktri_rt_fwd", "blocktri_rt_bwd")),
        (lambda: phase_solve(device, reps=10, planck=True),
         ("eig_n2_scatter", "blocktri_rt_n2")),
        (phase_cli, ("eig_n2_deltam", "blocktri_rt_n2")),
        (phase_cli_config2, ("eig_n2_scatter", "blocktri_rt_n2")),
        (phase_cli_config3, ("eig_beam", "blocktri_rt")),
    ]
    launches = dict.fromkeys(KERNELS, 0)
    for phase, owned in owners:
        for fn in wrappers.values():
            fn.launches = 0
        rec = phase()
        counts = {k: fn.launches for k, fn in wrappers.items()}
        missed = [k for k in owned if counts[k] == 0]
        if missed:
            raise SmokeFailure(f"{rec['phase']} {rec.get('input', '')} "
                               f"skipped its kernels {missed}")
        for k, c in counts.items():
            launches[k] += c

    emit({"kernels": [
        {"name": k, "route": "cuda",
         "source": f"sbdart_tpu_torch/kernels/csrc/{KERNELS[k][2]}",
         "replaces": KERNELS[k][3], "launches": launches[k], **summary[k]}
        for k in KERNELS
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
