#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sbdart_tpu_torch) on one GPU and check it.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

or, to compare two checkouts on one card (run them in turns, all on the
same card: parent, change, change, parent), time the BVP and eigen
kernels of the package in another checkout at this script's shapes:

    python3 chip_smoke.py --ab PATH/TO/CHECKOUT [radsrc,solves,kernels,batch,graphs,sweep]

(the optional list picks --ab's groups: B7's rows, the radiance solves'
breakdowns, the other kernels' rows; all three by default; "batch", only
when named, times config 5's batch through run_batch; "graphs", likewise,
the cli configs' pipelines and the batch, replayed where the checkout
captures them; "sweep", likewise, the device memory over a run of
config 4 at nstr=32 for each of eight chunk-solver keys)

Phases, one JSON line each; the first failure exits non-zero:

  1. device   the card's name and power limit (nvidia-smi);
  2. build    nvcc builds the CUDA kernels from kernels/csrc/ (timed);
  3. kernel   each kernel against its plain torch version on the card at
              the main path's shapes, bar equality on every element of
              every output (NaN where the plain version has NaN), with
              both device times
              (torch.profiler), both wall times (CUDA events) and the
              bound (the larger of bytes over 3.35 TB/s and operations
              over 67 TFLOP/s): B1/B2 at 33 layers x 49152 columns, B3
              (nstr=4 thermal front end) at 33 x 49152, B4 with the BVP
              kernels B5 (full-W history) and B6 (rank-N history, forward
              and backward) at nstr 16 x 65 layers and nstr 8 x 33 layers
              x 6144 columns (the path runs B6 at the first and B5 at the
              second; both are timed at both); the radiance path's B7 at
              the nstr=16 bench shape (16 modes, 5 cosines, 65 layers x
              256 columns), B8 at 4 modes x 33 layers x 4096 columns, B4
              on the flat radiance lane axis (16 x 65 x 256); and B5/B6 at
              N = 2, 65 layers x 49152 columns; the generic path's B9
              (eigen chain; a lane group per lane at N >= 4) on the
              all-mode lanes of G1 (N = 8), G2 (N = 4) and G3 (N = 2),
              at N >= 4 with a NaN in one of 130 lanes, B10 (block-Thomas
              on assembled blocks) on G2's BVP (m = 8), B5/B6 at odd N on
              G4's (N = 3) and G5's (N = 5) BVP; B6 forward's group
              kernel beside its one-thread kernel wherever that runs
              (N = 8, 4, 2, 3, 5), and
              both designs where the reference streams at N = 2 (480
              layers x 49152 columns) and N = 3 (250 x 12288), the shapes
              the wrapper's rule by N is read at; B6 backward (its lane
              group kernel: the route runs it at every N) with a NaN
              column at N = 2 and 3 at those shapes, N = 8 (65 x 6144),
              10 (G7's 65 x 6144) and 16 (G9's 65 x 768), the shapes
              blocktri_rt_streamed.BWD_ONE_THREAD_N is read at; the
              group kernels past N = 8 on the generic path's flux BVP with
              a NaN injected in one column's right-hand side: B6 forward
              and backward at N = 10 (G7's, 65 layers x 6144) and N = 16
              (65 x 6144), B10 on G7's assembled blocks (m = 20), B5 at
              N = 9 (G8's, 33 x 6144) and N = 20 (6 x 6144); each also at
              130 columns or lanes; B5's two designs at each N the main
              path sends it (N = 1 to 5 and 8, the shapes
              blocktri_rt.RT_ONE_THREAD_N is read at); B10's two designs
              at each m the scan route sends it (m = 2, 4, 8, 16 and 18,
              with a NaN column: the shapes blocktri.BT_ONE_THREAD_M is
              read at); the group kernels
              past the shared memory of one column (a "shared_memory" line
              with the first N each kernel's whole column and its system
              alone no longer fit, then B5, B6 and B10 at the first of
              those and at nstr = 128, 3 layers x 3 columns with a NaN
              column: their far instances); P1 (the Planck band
              integral) at a config 5 band chunk's level field [1024, 32,
              3, 33] and emission [1024, 32, 3], on the stride-0 views the
              solve passes it, and at 130 columns; P2 (the thermal
              particular solution) at a config 5 band chunk's 1024
              columns x 32 bands (one card) and x 36 (the grid), 3
              k-terms x 32 layers, at 130 columns, and at nstr 8, 12 and
              16 on 64 columns x 4 bands; P3 (delta-M and the beam
              attenuations of the nstr=4 thermal front end) at the same
              two c5 shapes on the stride-0 views of mu0 and has_beam the
              solve passes it, and at 130 columns with a NaN lane, with
              and without delta-M;
  4. solve    solve_rte in float32 through the kernels against the plain
              path on the card (max-abs error / max-abs <= 5e-4), with
              band-columns/s for both, and the kernel path's device time
              split into each kernel and the glue, its device operations
              per solve and its idle share: fluxes at nstr=4 solar
              (16384 band-columns x 3 k-terms x 33 layers), nstr=16 solar
              (2048 x 3 x 65: B4, B6), nstr=4 thermal (16384 x 3 x 33)
              and nstr=4 solar at 65 layers (B1, B5 at N = 2); radiances
              (uu at 5 cosines x 3 azimuths, and the fluxes) at nstr=4
              (4096 x 33: B8, B2, B7), nstr=16 (256 x 65 and 2048 x 65:
              B4, B6, B7) and nstr=8 on a Hapke BRDF with the thermal
              source (512 x 33: B4, B5, B7); and the generic path
              (band-columns x 3 k-terms): G1 nstr=16 x 65 layers x 256,
              all modes without user angles (B9, B6); G2 nstr=8 x 33 x
              2048, all modes (B9, B5); G3 nstr=4 x 33 x 4096, all modes
              (B9 at N = 2, B2); G4 nstr=6 x 33 x 4096, fluxes with the
              Planck source (B5 at N = 3, the lane eigen route); G5
              nstr=10 x 33 x 256, radiances at the 5 x 3 view grid (B5 at
              N = 5, compute_radiances); G6 nstr=8 x 33 x 2048, fluxes on a
              Hapke BRDF (B4 flat, B5); and G2 again with
              bvp_method="scan", the assembled-block route (B9, B10);
              past N = 8, with rel_err 0.0 on every field: G7 nstr=20 x 65
              x 2048, fluxes (the lane eigen chain at N = 10, B6's group
              kernels); G8 nstr=18 x 33 x 2048, fluxes (B5's group kernel
              at N = 9), and again with bvp_method="scan" (B10's group
              kernel at m = 18); G9 nstr=32 x 65 x 256, radiances at the
              5 x 3 view grid (B6's group kernels at N = 16,
              compute_radiances); G10 nstr=128 x 3 layers x 4, fluxes,
              and again with bvp_method="scan" (the far instances of B6
              forward and of B10);
  5. cli      the sbdart CLI on BASELINE config 1 (Lambertian closure
              botup/botdn = albcon to 1e-5), config 2 (tropical LW, 4-40 um,
              nstr=4: OLR finite, positive, and within 1e-2 of the float64
              plain route on the card), config 3 (water cloud, nstr=16,
              SW+LW, 32 layers, so B4 and B5: iout=10 line finite; closure on
              its solar-only part) and config 4 (rural aerosol, nstr=16,
              radiances at 6 zenith x 3 azimuth angles, iout=20: uu finite,
              >= -1e-9 on the float64 route, the float32 route within
              1e-2 of it, the mean TOA radiance above the same run's
              without aerosol), and config 4's namelist at nstr=10 and at
              nstr=32 (the generic path; B6's group kernels at N = 16)
              under the same checks;
  6. albtrn   ibcnd=1 (slab albedo and transmission, nstr=4: B1, B2)
              through the CLI on config 1's column at three incidence
              angles: finite, 0 <= albedo, trn <= 1 and albedo + trn <= 1
              (to 1e-5) over the black surface, the kernel route within
              5e-4 of the plain route;
     batch    BASELINE config 5 at a reduced scale through run_batch: the
              full 0.25-40 um sweep (1989 samples x 3 k-terms x 32
              layers, cloud and aerosol) x 32 solar zeniths x 128
              perturbed columns, in column chunks of 1024 and band chunks
              of 32 (the Planck source on every chunk: B3, B2; every
              band-chunk solve after the first replayed as one CUDA
              graph: a "captured" entry with its capture and instantiate
              seconds, node count and pool bytes, its first two column
              chunks to the bit from the same chunks run eagerly), with
              columns/s, band-columns/s and one column chunk's device busy
              ms and idle share: fluxes finite, a resume from its
              checkpoints (the last one removed and recomputed) equal to
              the first run bit for bit, the nominal column within 5e-4 of
              run_pipeline's integrated fluxes, fdn >= -1e-6 of its max on
              the float64 plain route (65 columns), float32 within 1e-2 of
              it there and its fdn >= -5e-4 of its max; its solar-only
              sub-batch (0.25-4 um, nothrm=1, 64 columns: B1, B2) within
              5e-4 of the plain path;
     distributed  init_distributed on NCCL with a world of one: run_batch
              (config 5's first 256 columns in two column chunks) through
              the process-group route with a checkpoint directory, equal
              to the run without one, bit for bit; then (a "resume" line
              with its seconds) its resumes on the grid: from every
              checkpoint equal and launching no kernel, with one file
              poisoned showing the poison, with that file deleted
              recomputing that chunk alone, equal again; and (a
              "local_rank" line) sharding._local_rank refusing, with
              LOCAL_RANK unset, a process id at the card count;
  7. planck_total  sigma T^4 / pi in float64 on the card over 1e-6-1e4 K
              against NumPy's, relative error <= 1e-12.

Captured solves (sbdart_tpu_torch/ops/graph.py): after each solve line of
phase 4, a "graph" line for the same cell.  Where ops/graph.py's rule
admits the route, the solve (its eager run the captured call's warm-up)
is captured and replayed on the same inputs and then on fresh ones (the
cell at seed 1) against a fresh eager solve, each to the bit, NaN
positions too; the replays must move the launch counters of the cell's
kernels; the line gives the eager and replayed wall (CUDA events),
device busy and idle share (profiler), the graph's node count, capture
and instantiate seconds and pool bytes.  Where the rule leaves it eager
(G10), "graph": false and the reason.  Each cli line of phase 5 adds
"graph" (the rule's verdict), "graph_rel_err" (api.run's result, every
chunk replayed where captured, against the same run with capture ruled
out: 0.0 on every field) and the eager run's seconds.

Kernel launch counters are zeroed just before each run of phases 4 to
6 and read just after it: each kernel must have been launched by the runs
whose path holds it (a replay adds what its capture counted); B5's eager
launches on phases 4 to 6 are also counted by shape (an "rt_shapes"
line).  Then come the run's seconds (in all, the kernel
phase, each main-path phase), the kernels summary, the nvidia-smi line,
and as the last line {"ok": true, "device": {...}}.  Without a CUDA
device the script fails.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

NLYR = 33
NBC = 16384            # band-columns
NK = 3                 # k-terms per band-column
B = NBC * NK           # columns the kernels see
KERNEL_BAR = "equal"           # kernel vs plain: every element, NaN positions too
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
OLR_BAR = 1e-2                 # f32 kernel path vs f64 plain route (CLI)
# bench.py:_radiance_throughput's view grid and shape (nstr=16, 65 layers,
# 256 band-columns, 65 moments)
UMU_VIEW = (0.2, 0.5, 0.9, -0.3, -0.8)
PHI_VIEW = (0.0, 90.0, 180.0)
NBC_RAD16 = 256
# BASELINE config 4: rural aerosol, 16 streams, radiances on a uzen x phi
# grid (0.25-2.0 um at 0.005 um)
INPUT_C4 = """ &INPUT
   idatm=2, iaer={iaer}, vis=10, albcon=0.1, nstr={nstr}, sza=40,
   wlinf=0.25, wlsup=2.0, wlinc=0.005,
   nzen=6, uzen=0,30,60,75,120,150, nphi=3, phi=0,90,180, iout=20
 /
"""
# ibcnd=1: the slab albedo/transmission of config 1's column (0.25-2 um at
# 0.005 um) at three incidence angles, over a black surface (albcon 0)
INPUT_ALBTRN = """ &INPUT
   idatm=2, wlinf=0.25, wlsup=2.0, wlinc=0.005, nstr=4, ibcnd=1,
   nzen=3, uzen=0,45,75
 /
"""
# BASELINE config 5 (pod-scale batch): the full 0.25-40 um sweep on a
# 20 cm^-1 grid (1989 samples x 3 k-terms x 32 layers), a water cloud and
# rural aerosol whose burdens the columns scale; C5_ZENITHS solar zeniths
# x C5_COLUMNS perturbed columns = 4096, cut from 10^5 by the script's time
# limit.  {nothrm}=1 with wlsup=4 is its solar-only sub-batch.
INPUT_C5 = """ &INPUT
   idatm=2, wlinf=0.25, wlsup={wlsup}, wlinc=-20.0, nothrm={nothrm},
   zcloud=2, tcloud=10, nre=10, iaer=1, vis=10, albcon=0.2, nstr=4
 /
"""
C5_ZENITHS, C5_COLUMNS = 32, 128
C5_COL_CHUNK, C5_BAND_CHUNK = 1024, 32
C5_PIPELINE_COLUMN = 8          # unperturbed, at the 9th solar zenith
# the NCCL world of one: config 5's first 256 columns in two column chunks
C5_DIST_COLUMNS, C5_DIST_COL_CHUNK = 256, 128
PLANCK_TOTAL_BAR = 1e-12        # f64 planck_total vs NumPy, relative
# 20 user cosines (SBDART's uzen limit, the kernel's MAX_ANGLES), both signs
UMU_20 = tuple(round(s * (0.05 + 0.1 * k), 2) for s in (1, -1)
               for k in range(10))
# the device operations torch's copies launch (.contiguous(), a reshape
# that cannot view, Tensor.copy_)
COPY_OPS = r"direct_copy_kernel|Memcpy DtoD"
# the card's peaks (H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


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


def graph_ms(fn, reps: int, replays: int = 5) -> float:
    """Device milliseconds per call of fn(), a kernel wrapper: `reps`
    calls captured in one CUDA graph and replayed, timed with CUDA events,
    so the host's dispatch is not in the time."""
    import torch

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    del graph
    torch.cuda.synchronize()
    return statistics.median(times)


def device_events(fn, reps: int, warmup: bool = True, cpu: bool = True):
    """The device operations (kernels, copies, fills) of `reps` calls of
    fn(), from torch.profiler, as (name, microseconds) pairs (after one
    call outside the profiler unless `warmup` is false; without recording
    the host's operations where `cpu` is false, which halves the
    profiler's cost on long windows)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]
                 + [ProfilerActivity.CPU] * cpu) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(fn, reps: int, match: str | None = None) -> float | None:
    """Device milliseconds per call of fn() as torch.profiler reports
    them: the summed durations of the CUDA work it launches (only kernels
    whose name `match`, a regular expression, finds, if given), or None
    when the profiler reported none (it can lose a window's kernel
    records)."""
    us = [t for name, t in device_events(fn, reps)
          if match is None or re.search(match, name)]
    return sum(us) / reps / 1e3 if us else None


def device_breakdown(fn, reps: int, warmup: bool = True) -> dict:
    """Per call of fn(): device ms in all, in each of the port's kernels
    (by its __global__ name) and in the rest (the torch glue), the number
    of device operations, and the copies among them (COPY_OPS: their
    count and device ms), from torch.profiler (None where it reported no
    device work); after one call outside the profiler unless `warmup` is
    false."""
    ev = device_events(fn, reps, warmup=warmup)
    if not ev:
        return {"device_busy_ms": None, "kernel_device_ms": None,
                "glue_device_ms": None, "device_ops_per_solve": None,
                "copy_ops_per_solve": None, "copy_device_ms": None}
    copies = [t for name, t in ev if re.search(COPY_OPS, name)]
    busy = sum(t for _, t in ev) / reps / 1e3
    per = {}
    for k, spec in KERNELS.items():
        us = [t for name, t in ev if re.search(spec[4], name)]
        if us:
            per[k] = sum(us) / reps / 1e3
    return {"device_busy_ms": busy, "kernel_device_ms": per,
            "glue_device_ms": busy - sum(per.values()),
            "device_ops_per_solve": len(ev) / reps,
            "copy_ops_per_solve": len(copies) / reps,
            "copy_device_ms": sum(copies) / reps / 1e3}


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
    from sbdart_tpu_torch.kernels import plain
    from sbdart_tpu_torch.solver import fluxlane

    args, kw, _ = lane_inputs(prob)
    b1_ops, use_dm = fluxlane.front_operands(
        *args, fbeam=kw["fbeam"], umu0=kw["umu0"], deltam=True)
    b1_ops = tuple(x.contiguous() for x in b1_ops)
    with plain():
        fe = fluxlane.front_end(*args, fbeam=kw["fbeam"], umu0=kw["umu0"],
                                deltam=True)
        sysm = fluxlane.bvp_system(fe, fbeam=kw["fbeam"],
                                   fisot=kw["fisot"], albedo=kw["albedo"])
    b2_ops = (fe.gp, fe.gm, fe.ee, sysm.refl, sysm.rhs)
    return b1_ops, use_dm, fe.tab, b2_ops


def general_kernel_operands(prob, nstr):
    """The front-end kernel's operands (B3 at nstr=4 with Planck, B4 at
    nstr >= 8, the tables appended) and the BVP kernel's (B2 or B5), as
    the main path builds them."""
    from sbdart_tpu_torch.kernels import plain
    from sbdart_tpu_torch.solver import fluxlane

    args, kw, pk = lane_inputs(prob)
    with plain():
        fe = fluxlane.front_end(*args, fbeam=kw["fbeam"], umu0=kw["umu0"],
                                deltam=True, nstr=nstr,
                                planck=pk is not None)
    _, mu0, scale_row, mu0_row = fluxlane.beam_rows(kw["fbeam"], kw["umu0"])
    if nstr == 4:
        front = (fluxlane.to_scan(fe.dm.ssalb), fluxlane.to_scan(fe.dm.gl, 2),
                 scale_row, mu0_row)
        extra = (fe.tab,)
    else:
        front = fluxlane.general_operands(fe.dm, fe.tab, mu0, scale_row)
        extra = (fe.tab.mu, fe.tab.w)
    with plain():
        sysm = fluxlane.bvp_system(fe, fbeam=kw["fbeam"], fisot=kw["fisot"],
                                   albedo=kw["albedo"], planck=pk)
    front = tuple(x.contiguous() for x in front) + extra
    return front, (fe.gp, fe.gm, fe.ee, sysm.refl, sysm.rhs)


def radiance_problem(nbc, nlyr, device, *, nstr, seed=0, planck=False,
                     brdf=False):
    """solve_rte's radiance inputs at bench.py:_radiance_throughput's
    distributions: dtau U(0.001, 0.6), ssalb U(0.05, 0.999), 65 HG moments
    of g U(0, 0.85), a beam in every column, umu0 U(0.2, 1), albedo
    U(0, 0.8), the 5 x 3 view grid; with `planck` the thermal case of
    flux_problem, with `brdf` DISORT's default Hapke surface.  Returns
    (dtau, ssalb, pmom) and the keywords."""
    import numpy as np
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    dtau = u(0.001, 0.6, nbc, nlyr)
    ssalb = u(0.05, 0.999, nbc, nlyr)
    g = u(0.0, 0.85, nbc, nlyr)
    pmom = g[..., None] ** torch.arange(65, device=device)
    kw = dict(nstr=nstr, fbeam=torch.ones(nbc, device=device),
              umu0=u(0.2, 1.0, nbc), albedo=u(0.0, 0.8, nbc), onlyfl=False,
              umu=np.array(UMU_VIEW), phi=np.array(PHI_VIEW))
    if planck:
        kw.update(planck=True, wvnlo=800.0, wvnhi=900.0, btemp=290.0,
                  fisot=0.3, temper=torch.linspace(250.0, 290.0, nlyr + 1,
                                                   device=device))
    if brdf:
        from sbdart_tpu_torch.solver.brdf import HapkeBrdf

        kw["brdf"] = HapkeBrdf()
    return (dtau, ssalb, pmom), kw


def radiance_kernel_operands(args, kw):
    """The operands the radiance path hands its three kernel entries (the
    flat eigen chain, the BVP solve and B7), captured from one run of its
    plain path: {entry: (positional args, keyword args)}."""
    import torch

    from sbdart_tpu_torch.solver import radlane
    from sbdart_tpu_torch.solver.disort import solve_rte

    seen = {}
    names = ("eig_beam_chain_lane", "solve_bvp", "rad_source_lane")
    saved = {n: getattr(radlane, n) for n in names}

    def spy(name):
        def call(*a, **k):
            seen[name] = (a, k)
            return saved[name](*a, **k)
        return call

    try:
        for n in names:
            setattr(radlane, n, spy(n))
        solve_rte(*args, eig_method="plain", dtype=torch.float32, **kw)
    finally:
        for n, fn in saved.items():
            setattr(radlane, n, fn)
    return seen


def radsrc_operands(device, nstr, nlyr, nbc, umu=UMU_VIEW, **cell):
    """B7's operands as the radiance path hands them to rad_source_lane
    (gp, gm, kk, zp and zm strided views of the eigen chain's flat
    output), captured from one run of the plain path of radiance_problem's
    cell at the user cosines `umu`: (operands, umu)."""
    import numpy as np

    args, kw = radiance_problem(nbc, nlyr, device, nstr=nstr, **cell)
    kw["umu"] = np.array(umu)
    *src, umu = radiance_kernel_operands(args, kw)["rad_source_lane"][0]
    return tuple(src), umu


def radsrc_bound(src, umu):
    """B7's bound on the path's operands (bound_of, with j [M, U, LB])."""
    import torch

    j = torch.empty((src[0].shape[0], len(umu), src[3].shape[-1]),
                    device=src[3].device)
    return bound_of("radsrc", src, (j,))


def generic_problem(nbc, nk, nlyr, device, *, nstr, onlyfl, angles=False,
                    planck=False, brdf=False, seed=0):
    """solve_rte inputs for the generic path: flux_problem's optics
    (nbc band-columns x nk k-terms x nlyr layers, nstr + 1 moments, or 65
    with `angles`); with `angles` the 5 x 3 view grid, with `brdf`
    DISORT's default Hapke surface.  Returns (dtau, ssalb, pmom) and the
    keywords."""
    import numpy as np

    prob = flux_problem(nbc, nk, nlyr, device, seed=seed,
                        nmom=65 if angles else nstr + 1, planck=planck)
    args = (prob.pop("dtau"), prob.pop("ssalb"), prob.pop("pmom"))
    kw = dict(nstr=nstr, onlyfl=onlyfl, **prob)
    if angles:
        kw.update(umu=np.array(UMU_VIEW), phi=np.array(PHI_VIEW))
    if brdf:
        from sbdart_tpu_torch.solver.brdf import HapkeBrdf

        kw["brdf"] = HapkeBrdf()
    return args, kw


def generic_kernel_operands(args, kw):
    """The operands the generic path hands B9 (`eig_chain_lane`: cppl,
    cpml [N, N, lanes], mu, w) and its fused BVP solve (gp, gm, ee, refl,
    rhs), captured from one float32 run of its plain path:
    {entry: (positional args, keyword args)}."""
    import torch

    from sbdart_tpu_torch.kernels import blocktri_rt_streamed, eig_chain
    from sbdart_tpu_torch.solver.disort import solve_rte

    seen = {}
    mods = {"eig_chain_lane": eig_chain, "solve_bvp": blocktri_rt_streamed}
    saved = {n: getattr(m, n) for n, m in mods.items()}

    def spy(name):
        def call(*a, **k):
            seen[name] = (a, k)
            return saved[name](*a, **k)
        return call

    try:
        for n, m in mods.items():
            setattr(m, n, spy(n))
        solve_rte(*args, eig_method="plain", dtype=torch.float32, **kw)
    finally:
        for n, m in mods.items():
            setattr(m, n, saved[n])
    return seen


# each group-per-column kernel and the one-thread kernel whose work it
# does (the name flops_of counts it under)
GROUP_OF = {"blocktri_rt_fwd_group": "blocktri_rt_fwd",
            "blocktri_rt_bwd_group": "blocktri_rt_bwd",
            "blocktri_rt_group": "blocktri_rt",
            "block_thomas_group": "block_thomas"}


def _ge_flops(m, r):
    """Operations of a pivoted elimination of an m x m system with r
    right-hand sides, back-substitution included."""
    return 2.0 * m**3 / 3.0 + 2.0 * m * m * r


def flops_of(kname, args):
    """The operations a kernel does on these inputs, counted from the
    formulas of its source (an estimate to within a small factor: each
    kernel is bound by its bytes except where noted in PERF.md)."""
    from sbdart_tpu_torch.kernels.eig_beam import SWEEPS_F32

    kname = GROUP_OF.get(kname, kname)
    if kname == "planck_band":
        return planck_flops(*args)
    if kname == "thermal_particular_scan":
        return thermal_flops(*args)
    if kname == "deltam_attenuation":
        return deltam_flops(*args)
    if kname in ("eig_n2_deltam", "eig_n2_scatter"):
        lanes = args[0].numel()
        return (250 if kname == "eig_n2_deltam" else 230) * lanes
    if kname == "eig_n2_planar":
        return 150 * args[0].shape[0] * args[0].shape[-1]
    if kname == "eig_beam":
        nlyr, n, _, b = args[0].shape
        per = (n**3 / 3 + SWEEPS_F32 * (n * (n - 1) / 2) * 12 * n
               + 5 * n**3 + 2 * n**3 + _ge_flops(n, 1))
        return nlyr * b * per
    if kname == "eig_chain":
        nlyr, n, _, b = args[0].shape
        eigh = (SWEEPS_F32 * (n * (n - 1) / 2) * 12 * n if n > 2 else 40)
        return nlyr * b * (n**3 / 3 + eigh + 5 * n**3 + 4 * n * n)
    if kname == "block_thomas":
        nlyr, m, _, b = args[0].shape
        return nlyr * b * (2 * m**3 + 2 * m * m + _ge_flops(m, m + 1)
                           + 2 * m * m)
    if kname == "radsrc":
        nm, nu, n, nstr = args[0].shape
        lb = args[3].shape[-1]
        per = 4 * n * nstr + 8 * n * n + 4 * n + 3 * nstr + 40 * n + 30
        return nm * nu * lb * per
    nlyr, n, _, b = args[0].shape
    m = 2 * n
    per = {
        "blocktri_rt_n2": _ge_flops(m, m + 1) + 2 * n * m * (m + 1)
        + 2 * m * m,
        "blocktri_rt": _ge_flops(m, m + 1) + 2 * n * m * (m + 1)
        + 2 * m * m,
        "blocktri_rt_fwd": _ge_flops(m, n + 1) + 4 * n * m * n + 2 * n * m,
        "blocktri_rt_bwd": 4 * n * m + m,
    }[kname]
    # the surface rows' R [gm e, gp] (4 N^3) count on the last layer only,
    # the one where the plain versions' factor `last` is not 0
    surface = 0 if kname == "blocktri_rt_bwd" else 4 * n**3
    # B6 backward's recursion runs over layers L - 2 .. 0
    layers = nlyr - 1 if kname == "blocktri_rt_bwd" else nlyr
    return b * (layers * per + surface)


def bound_of(kname, args, outs):
    """The least time the card could take for a kernel's work: the larger
    of its bytes (each tensor input read once, each output written once)
    over 3.35 TB/s and its operations over 67 TFLOP/s (float32)."""
    import torch

    flops = flops_of(kname, args)
    if GROUP_OF.get(kname, kname) == "blocktri_rt_bwd":
        # the recursion reads ub_l from layer l + 1 and C_l of layers
        # 0..L-2 only (x_{L-1} = y_{L-1})
        gp, gm, ee, cs, ys = args
        args = (gp[1:], gm[1:], ee[1:], cs[:-1], ys)
    seen, nbytes = set(), 0
    for t in list(args) + list(outs):
        if isinstance(t, torch.Tensor) and t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            n = t.numel()
            if kname in ("planck_band", "thermal_particular_scan",
                         "deltam_attenuation"):
                # P1-P3 read their views in place: each element once
                n = math.prod(size for size, stride
                              in zip(t.shape, t.stride()) if stride)
            nbytes += n * t.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def compare(name, got, want):
    """Worst error and misses of one output plane against its plain
    version.  The bar is equality: the kernels follow their plain versions'
    operation order with --fmad=false, so every element must be the plain
    version's, NaN where it has NaN (a NaN column is the float32 beam
    resonance of ROADMAP Queue C, or one injected on purpose)."""
    import torch

    if got.shape != want.shape:
        raise SmokeFailure(f"{name}: shape {tuple(got.shape)} != "
                           f"{tuple(want.shape)}")
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    if not bool(torch.isfinite(got[~nan_g]).all()):
        raise SmokeFailure(f"{name}: kernel output infinite")
    if not torch.equal(nan_g, nan_w):
        raise SmokeFailure(f"{name}: NaN at {int(nan_g.sum())} elements, "
                           f"the plain version at {int(nan_w.sum())}")
    diff = (got.double() - want.double()).abs()[~nan_w]
    miss = diff > 0.0
    return {
        "output": name,
        "max_abs_err": float(diff.max()) if diff.numel() else 0.0,
        "misses": int(miss.sum()),
        "miss_max_abs": float(diff[miss].max()) if bool(miss.any()) else 0.0,
        "nan": int(nan_g.sum()),
        "elements": got.numel(),
    }


def check_kernel(kname, names, kern, plain, b, args=()):
    """One kernel against its plain version on the same operands: a row
    of per-output comparisons, and the kernel's bound on these operands
    (`args`, the tensors it reads).  The kernel follows its plain
    version's operation order on the same inputs, eigenmode order
    included, so any element outside the bar fails."""
    got, want = kern(), plain()
    if not isinstance(got, (tuple, list)):
        got, want = (got,), (want,)
    outs = [compare(n, g, w) for n, g, w in zip(names, got, want)]
    for o in outs:
        if o["misses"]:
            raise SmokeFailure(f"{kname}/{o['output']} at B={b}: "
                               f"{o['misses']} misses of the bar")
    row = {"kernel": kname, "outputs": outs}
    if args:
        row.update(bound_of(kname, args, got))
    return row


def time_kernel(row, kern, plain, reps, plain_reps):
    """ms: the kernel's device time per launch (a CUDA graph of `reps`
    launches, CUDA events); wall_ms: per wrapper call run eagerly, the
    host's dispatch included (CUDA events); plain_ms: per call of the
    plain version, run eagerly (CUDA events); profiler_ms: the kernel's
    time as torch.profiler reports it (None when it lost the records)."""
    row.update(
        ms=graph_ms(kern, reps),
        plain_ms=timed_ms(plain, plain_reps, warmup=1),
        wall_ms=timed_ms(kern, reps),
        profiler_ms=device_ms(kern, reps, match=KERNELS[row["kernel"]][4]),
    )


def merge(summary, part):
    """Fold one phase's kernels summary into the whole run's: the largest
    error over both, the times and bound of whichever holds them."""
    for k, entry in part.items():
        mine = summary.setdefault(k, {"max_abs_err": 0.0})
        err = max(mine["max_abs_err"], entry["max_abs_err"])
        mine.update(entry)
        mine["max_abs_err"] = err
    return summary


def fold(summary, row, main):
    """Fold a checked row into the kernels summary: the largest error over
    every shape checked, and the times of the main shape."""
    entry = summary.setdefault(row["kernel"], {"max_abs_err": 0.0})
    entry["max_abs_err"] = max(entry["max_abs_err"],
                               *(o["max_abs_err"] for o in row["outputs"]))
    if main:
        entry.update(ms=row["ms"], plain_ms=row["plain_ms"],
                     bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                     library_ms=None)


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
                    *b1_ops, tab, use_deltam=use_dm), reps, b1_ops),
            "blocktri_rt_n2": (
                ("xs",), lambda: block_thomas_rt_n2(*b2_ops),
                lambda: block_thomas_rt_n2_plain(*b2_ops),
                max(3, reps // 4), b2_ops),
        }
        rows = []
        for kname, (names, kern, plain, plain_reps, args) in calls.items():
            row = check_kernel(kname, names, kern, plain, b, args)
            if b == B:
                time_kernel(row, kern, plain, reps, plain_reps)
            fold(summary, row, main=b == B)
            rows.append(row)
        emit({"phase": "kernel", "layers": NLYR, "columns": b,
              "bar": KERNEL_BAR, "results": rows})
    return summary


def rt_kernel(n):
    """The name of the B5 kernel block_thomas_rt runs at N = n."""
    from sbdart_tpu_torch.kernels.blocktri_rt import RT_ONE_THREAD_N

    return "blocktri_rt" if n in RT_ONE_THREAD_N else "blocktri_rt_group"


def bt_kernel(m):
    """The name of the B10 kernel block_thomas runs at block size m."""
    from sbdart_tpu_torch.kernels.blocktri import thomas_entry

    return ("block_thomas" if thomas_entry(m) == "sbdart_block_thomas"
            else "block_thomas_group")


def bvp_calls(bvp, hist):
    """The check_kernel calls of B5 and B6 forward (each in both designs
    where both are built: the one-thread kernels at the N of
    RT_ONE_THREAD_N and FWD_ONE_THREAD_N) and B6 backward (through its
    route, on the plain forward's history `hist`) on one BVP's
    operands."""
    from sbdart_tpu_torch.kernels.blocktri_rt import (
        RT_ONE_THREAD_N, block_thomas_rt, block_thomas_rt_group,
        block_thomas_rt_plain)
    from sbdart_tpu_torch.kernels.blocktri_rt_streamed import (
        FWD_ONE_THREAD_N, block_thomas_rt_bwd, block_thomas_rt_bwd_plain,
        block_thomas_rt_fwd, block_thomas_rt_fwd_group,
        block_thomas_rt_fwd_plain)

    calls = {
        "blocktri_rt": (
            ("xs",), lambda: block_thomas_rt(*bvp),
            lambda: block_thomas_rt_plain(*bvp), 2, bvp),
        "blocktri_rt_group": (
            ("xs",), lambda: block_thomas_rt_group(*bvp),
            lambda: block_thomas_rt_plain(*bvp), 2, bvp),
        "blocktri_rt_fwd": (
            ("cs", "ys"), lambda: block_thomas_rt_fwd(*bvp),
            lambda: block_thomas_rt_fwd_plain(*bvp), 2, bvp),
        "blocktri_rt_fwd_group": (
            ("cs", "ys"), lambda: block_thomas_rt_fwd_group(*bvp),
            lambda: block_thomas_rt_fwd_plain(*bvp), 2, bvp),
        "blocktri_rt_bwd_group": (
            ("xs",), lambda: block_thomas_rt_bwd(*bvp[:3], *hist),
            lambda: block_thomas_rt_bwd_plain(*bvp[:3], *hist), 3,
            bvp[:3] + tuple(hist)),
    }
    if bvp[0].shape[1] not in FWD_ONE_THREAD_N:
        del calls["blocktri_rt_fwd"]
    if bvp[0].shape[1] not in RT_ONE_THREAD_N:
        del calls["blocktri_rt"]
    return calls


def phase_kernels_general(device, reps):
    """B3 (nstr=4 thermal front end), B4, B5 and B6 (nstr 16 and 8)
    against their plain versions at the main path's shapes and at 130
    columns.  B6's backward kernel is held against its plain version on
    the plain forward's history."""
    from sbdart_tpu_torch.kernels.blocktri_rt_streamed import (
        block_thomas_rt_fwd_plain, reference_streams)
    from sbdart_tpu_torch.kernels.eig_beam import (
        eig_beam_chain, eig_beam_chain_plain)
    from sbdart_tpu_torch.kernels.eig_n2_scatter import (
        eig_beam_scatter_n2, eig_beam_scatter_n2_plain)

    summary = {}
    # (nstr, layers, columns)
    cases = [(4, NLYR, NBC), (16, NLYR16, NBC16), (8, NLYR, NBC16)]
    # the nstr whose shape gives each kernel's times in the summary: one
    # where the main path runs it (B6 backward's are bwd_rule's, on
    # contiguous operands)
    summary_nstr = {"eig_n2_scatter": 4, "eig_beam": 16,
                    "blocktri_rt": None, "blocktri_rt_group": None,
                    "blocktri_rt_fwd": None, "blocktri_rt_fwd_group": 16,
                    "blocktri_rt_bwd_group": None}
    for nstr, nlyr, nbc in cases:
        for cols, nk in ((nbc, NK), (130, 1)):
            prob = flux_problem(cols, nk, nlyr, device, nmom=nstr + 1,
                                planck=nstr == 4)
            front, bvp = general_kernel_operands(prob, nstr)
            b = bvp[0].shape[-1]
            if nstr == 4:
                calls = {"eig_n2_scatter": (
                    EIG_NAMES, lambda: eig_beam_scatter_n2(*front),
                    lambda: eig_beam_scatter_n2_plain(*front), reps, front)}
            else:
                hist = block_thomas_rt_fwd_plain(*bvp)
                calls = {
                    "eig_beam": (
                        EIG_NAMES, lambda: eig_beam_chain(*front),
                        lambda: eig_beam_chain_plain(*front),
                        max(3, reps // 4), front),
                    **bvp_calls(bvp, hist),
                }
            streams = nstr > 4 and reference_streams(nlyr, nstr // 2)
            rows = []
            for kname, (names, kern, plain, plain_reps, args) in \
                    calls.items():
                row = check_kernel(kname, names, kern, plain, b, args)
                if cols == nbc:
                    time_kernel(row, kern, plain, reps, plain_reps)
                row["on_main_path"] = (
                    kname in ("eig_beam", "eig_n2_scatter")
                    or (kname == rt_kernel(nstr // 2) and not streams)
                    or (kname in ("blocktri_rt_fwd_group",
                                  "blocktri_rt_bwd_group") and streams))
                fold(summary, row,
                     main=summary_nstr[kname] == nstr and cols == nbc)
                rows.append(row)
            emit({"phase": "kernel", "nstr": nstr, "layers": nlyr,
                  "columns": b, "bar": KERNEL_BAR,
                  "results": rows})
    return summary


def phase_kernels_radiance(device, reps):
    """The radiance path's kernels against their plain versions on the
    operands the path gives them: B7 at the nstr=16 bench shape (M = 16,
    U = 5, LB = 65 x 256), at LB = 130 (65 x 2) and at the nstr=4 shape
    (N = 2, 4 x 33 x 4096), on the path's own strided views of the eigen
    output (timed at the bench shape); B4 on the flat lane axis of that
    solve (16 x 65 x 256 lanes); B8 at the nstr=4 shape (4 x 33 x 4096
    lanes) and at its first 130 lanes."""
    from sbdart_tpu_torch.kernels.eig_beam import (
        eig_beam_chain, eig_beam_chain_plain)
    from sbdart_tpu_torch.kernels.eig_n2 import (
        eig_beam_chain_n2, eig_beam_chain_n2_plain)
    from sbdart_tpu_torch.kernels.radsrc import (
        rad_source_lane, rad_source_lane_plain)

    summary = {}
    for nstr, nlyr, nbc in ((16, NLYR16, NBC_RAD16), (16, NLYR16, 2),
                            (4, NLYR, 4096)):
        ops = radiance_kernel_operands(
            *radiance_problem(nbc, nlyr, device, nstr=nstr))
        (cppl, cpml, r1, r2, mu0, tab), _ = ops["eig_beam_chain_lane"]
        flat = tuple(x.reshape((1,) + x.shape).contiguous()
                     for x in (cppl, cpml, r1, r2)) + (mu0.contiguous(),)
        main = nbc != 2
        *src, umu = ops["rad_source_lane"][0]
        calls = {"radsrc": (
            ("j",), lambda: rad_source_lane(*src, umu),
            lambda: rad_source_lane_plain(*src, umu), 3, src)}
        if nstr == 16 and main:
            calls["eig_beam"] = (
                EIG_NAMES, lambda: eig_beam_chain(*flat, tab.mu, tab.w),
                lambda: eig_beam_chain_plain(*flat, tab.mu, tab.w), 3,
                flat)
        elif nstr == 4:
            for cols in (flat[0].shape[-1], 130):
                sl = tuple(x[..., :cols].contiguous() for x in flat)
                row = check_kernel(
                    "eig_n2_planar", EIG_NAMES,
                    lambda: eig_beam_chain_n2(*sl, tab),
                    lambda: eig_beam_chain_n2_plain(*sl, tab), cols, sl)
                if cols != 130:
                    time_kernel(row, lambda: eig_beam_chain_n2(*sl, tab),
                                lambda: eig_beam_chain_n2_plain(*sl, tab),
                                reps, reps)
                fold(summary, row, main=cols != 130)
                emit({"phase": "kernel", "path": "radiance", "nstr": nstr,
                      "lanes": cols, "bar": KERNEL_BAR,
                      "results": [row]})
        rows = []
        for kname, (names, kern, plain, plain_reps, args) in calls.items():
            row = check_kernel(kname, names, kern, plain, nbc, args)
            timed = main and nstr == 16
            if timed:
                time_kernel(row, kern, plain, reps, plain_reps)
            fold(summary, row, main=timed and kname == "radsrc")
            rows.append(row)
        emit({"phase": "kernel", "path": "radiance", "nstr": nstr,
              "layers": nlyr, "band_columns": nbc,
              "bar": KERNEL_BAR, "results": rows})
    return summary


def phase_kernels_bvp_n2(device, reps):
    """B5 and B6 at N = 2 (nstr=4 beyond 51 layers: the reference's planar
    tile no longer fits) against their plain versions, at 65 layers x
    49152 columns and 130 columns."""
    from sbdart_tpu_torch.kernels.blocktri_rt_streamed import (
        block_thomas_rt_fwd_plain)

    summary = {}
    for nbc, nk in ((NBC, NK), (130, 1)):
        _, _, _, bvp = kernel_operands(flux_problem(nbc, nk, 65, device))
        hist = block_thomas_rt_fwd_plain(*bvp)
        b = bvp[0].shape[-1]
        rows = []
        for kname, (names, kern, plain, plain_reps, args) in \
                bvp_calls(bvp, hist).items():
            row = check_kernel(kname, names, kern, plain, b, args)
            if nbc == NBC:
                time_kernel(row, kern, plain, reps, plain_reps)
            rows.append(row)
        emit({"phase": "kernel", "nstr": 4, "layers": 65, "columns": b,
              "bar": KERNEL_BAR, "results": rows})
    return summary


def c5_planck_chunk(device, ncol=C5_COL_CHUNK, nband=C5_BAND_CHUNK, nk=NK,
                    nlev=33, seed=0):
    """A config 5 band chunk's Planck inputs as the batch hands them to
    solve_rte: band edges [1, B, 1] over 250-40,000 cm^-1 (20 cm^-1 wide)
    and a [1, B, 1, L+1] temperature 200-300 K at its 33 levels (32
    layers), with the solar bands
    (every third here) at the 1e-4 K mask, each expanded (stride 0) to
    the batch [ncol, B, nk]: (wvnlo, wvnhi, temper, the thermal mask)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    lo = 250.0 + 39750.0 * torch.rand((1, nband, 1), generator=gen,
                                      device=device)
    hi = lo + 20.0
    prof = 200.0 + 100.0 * torch.rand((nlev,), generator=gen, device=device)
    thermal = (torch.arange(nband, device=device) % 3 != 0)[None, :, None]
    temper = torch.where(thermal[..., None], prof, 1e-4)
    batch = (ncol, nband, nk)
    return (lo.expand(batch), hi.expand(batch),
            temper.expand(batch + (nlev,)), thermal.expand(batch))


def planck_operands(device, **chunk):
    """P1's two calls of a c5 band-chunk solve, as fluxlane._thermal makes
    them: {"level": the level field's (wvnlo, wvnhi, temper) [C, B, k,
    L+1], "emission": the surface emission's [C, B, k]}."""
    import torch

    lo, hi, temper, thermal = c5_planck_chunk(device, **chunk)
    btemp = torch.where(thermal, 290.0, 1e-4)
    btemp_eff = torch.where(btemp > 0, btemp, temper[..., -1])
    return {"level": (lo[..., None], hi[..., None], temper),
            "emission": (lo, hi, btemp_eff)}


def planck_flops(wvnlo, wvnhi, temp):
    """P1's operations on these inputs, by the branch each x = c2 nu / T
    takes (an expf counted as one): 22 on the power series, 2 + 16 x 12
    + 2 on the exponential one, and 9 an element around them."""
    import torch

    from sbdart_tpu_torch.constants import C2_RADIATION

    t = torch.clamp_min(temp.float(), 1e-6)
    n = torch.broadcast_shapes(wvnlo.shape, wvnhi.shape, temp.shape).numel()
    nexp = sum(int((C2_RADIATION * w.float() / t > 1.0).sum())
               for w in (wvnlo, wvnhi))
    return (2 * n - nexp) * 22 + nexp * (2 + 16 * 12 + 2) + n * 9


def phase_kernels_planck(device, reps):
    """P1 against its plain version at a c5 band chunk's two shapes (the
    level field [1024, 32, 3, 33] and the emission [1024, 32, 3]), on the
    stride-0 views the solve passes it, and on 130 columns; the level
    field's times are the kernels summary's."""
    import torch

    from sbdart_tpu_torch.kernels.planck import planck_band, planck_band_plain

    summary = {}
    for ncol in (C5_COL_CHUNK, 130):
        rows = []
        for shape, args in planck_operands(device, ncol=ncol).items():
            def kern(a=args):
                return planck_band(*a, torch.float32)

            def plain(a=args):
                return planck_band_plain(*a, torch.float32)

            row = check_kernel("planck_band", ("b",), kern, plain, ncol,
                               args)
            row["shape"] = shape
            main = ncol == C5_COL_CHUNK
            if main:
                time_kernel(row, kern, plain, reps, max(3, reps // 2))
            fold(summary, row, main=main and shape == "level")
            rows.append(row)
        emit({"phase": "kernel", "path": "planck", "columns": ncol,
              "bands": C5_BAND_CHUNK, "k_terms": NK, "levels": NLYR,
              "bar": KERNEL_BAR, "results": rows})
    return summary


def thermal_operands(device, ncol=C5_COL_CHUNK, nband=C5_BAND_CHUNK, nk=NK,
                     nlyr=NLYR - 1, nstr=4, seed=0, floor_share=0.0,
                     moments=(0.0, 0.85)):
    """P2's operands of a band-chunk solve, as fluxlane._thermal hands them
    over: the delta-M result (ssalb, dtau [C, B, k, L], gl [C, B, k, L,
    nstr]) of optics drawn as flux_problem's (dtau U(0.001, 0.6), ssalb
    U(0.05, 0.999), HG moments of g drawn from `moments`), a share
    `floor_share` of the layers at dtau 1e-9, under the float32 slope
    floor, and b_level [C, B, k, L+1] from P1 on a c5 chunk's
    temperatures (c5_planck_chunk, the solar bands at 1e-4 K); and the
    angular tables of nstr."""
    import torch

    from sbdart_tpu_torch.kernels.planck import planck_band
    from sbdart_tpu_torch.solver.deltam import apply_deltam
    from sbdart_tpu_torch.solver.eig import angular_tables

    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (ncol, nband, nk, nlyr)

    def u(lo, hi, *size):
        return lo + (hi - lo) * torch.rand(size, generator=gen,
                                           device=device)

    dtau = u(0.001, 0.6, *shape)
    if floor_share:
        dtau = torch.where(u(0.0, 1.0, *shape) < floor_share, 1e-9, dtau)
    ssalb = u(0.05, 0.999, *shape)
    g = u(*moments, *shape)
    pmom = g[..., None] ** torch.arange(nstr + 1, device=device)
    dm = apply_deltam(dtau, ssalb, pmom, nstr)
    lo, hi, temper, _ = c5_planck_chunk(device, ncol=ncol, nband=nband,
                                        nk=nk, nlev=nlyr + 1, seed=seed)
    b_level = planck_band(lo[..., None], hi[..., None], temper,
                          torch.float32)
    return (dm.ssalb, dm.dtau, dm.gl, b_level), angular_tables(nstr, 1)


def thermal_flops(ssalb, dtau, gl, b_level):
    """P2's operations on these inputs, counted from its source: per lane
    the moments (4 nstr), C^pp/C^pm twice (8 nstr N^2), alpha -+ beta
    (8 N^2), the right-hand sides (4 N + 6), the two pivoted solves and
    the recombination (5 N); a division counted as one."""
    import torch

    nstr = gl.shape[-1]
    n = nstr // 2
    lanes = torch.broadcast_shapes(ssalb.shape, dtau.shape,
                                   gl.shape[:-1]).numel()
    per = (4 * nstr + 8 * nstr * n * n + 8 * n * n + 4 * n + 6
           + _ge_flops(n, 2) + _ge_flops(n, 1) + 5 * n)
    return lanes * per


def phase_kernels_thermal(device, reps):
    """P2 against its plain version at both c5 band-chunk shapes (one
    card's 1024 columns x 32 bands and the grid's 1024 x 36, 3 k-terms x
    32 layers, N = 2), at 130 columns, and at N = 4, 6, 8 on 64 columns;
    the one-card shape's times are the kernels summary's."""
    import torch

    from sbdart_tpu_torch.kernels.thermal import (
        thermal_particular_scan,
        thermal_particular_scan_plain,
    )

    summary = {}
    cases = [(C5_COL_CHUNK, C5_BAND_CHUNK, 4, True),
             (C5_COL_CHUNK, 36, 4, True), (130, C5_BAND_CHUNK, 4, False),
             (64, 4, 8, False), (64, 4, 12, False), (64, 4, 16, False)]
    rows = []
    for ncol, nband, nstr, timed in cases:
        args, tab = thermal_operands(device, ncol=ncol, nband=nband,
                                     nstr=nstr, floor_share=0.01)

        def kern(a=args, tab=tab):
            return thermal_particular_scan(*a, tab)

        def plain(a=args, tab=tab):
            return thermal_particular_scan_plain(*a, tab)

        row = check_kernel("thermal_particular_scan",
                           ("y0p", "y0m", "y1p", "y1m"), kern, plain, ncol,
                           args)
        row.update(columns=ncol, bands=nband, nstr=nstr)
        if timed:
            time_kernel(row, kern, plain, reps, max(3, reps // 2))
        main = (ncol, nband) == (C5_COL_CHUNK, C5_BAND_CHUNK)
        fold(summary, row, main=main)
        rows.append(row)
    emit({"phase": "kernel", "path": "thermal", "k_terms": NK,
          "layers": NLYR - 1, "bar": KERNEL_BAR, "results": rows})
    return summary


def deltam_operands(device, ncol=C5_COL_CHUNK, nband=C5_BAND_CHUNK, nk=NK,
                    nlyr=NLYR - 1, seed=0):
    """P3's operands of a band-chunk solve, as fluxlane.front_end hands
    them over: optics [C, B, k, L] drawn as flux_problem's (dtau U(0.001,
    0.6), ssalb U(0.05, 0.999)) with config 5's 5 HG moments a layer
    [C, B, k, L, 5], and beam_rows' mu0 and has_beam [C, B, k] from a
    band's beam (none in a fifth of the bands) and a column's zenith
    cosine U(0.2, 1), each expanded (stride 0) as solve_rte does."""
    import torch

    from sbdart_tpu_torch.solver.fluxlane import beam_rows

    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (ncol, nband, nk, nlyr)

    def u(lo, hi, *size):
        return lo + (hi - lo) * torch.rand(size, generator=gen,
                                           device=device)

    dtau = u(0.001, 0.6, *shape)
    ssalb = u(0.05, 0.999, *shape)
    pmom = u(0.0, 0.85, *shape)[..., None] ** torch.arange(5, device=device)
    fbeam = (u(0.0, 1.0, 1, nband, 1) < 0.8).float()
    umu0 = u(0.2, 1.0, ncol, 1, 1)
    has_beam, mu0, _, _ = beam_rows(fbeam.expand(shape[:-1]),
                                    umu0.expand(shape[:-1]))
    return dtau, ssalb, pmom, mu0, has_beam


def deltam_flops(dtau, ssalb, pmom, mu0, has_beam):
    """P3's operations, counted from its source: per lane-layer 20 for
    delta-M (the clamps, products, differences and 5 divisions) and 8 for
    the two running sums and attenuations, an expf and a division counted
    as one."""
    import torch

    lanes = torch.broadcast_shapes(dtau.shape, ssalb.shape,
                                   pmom.shape[:-1]).numel()
    return lanes * 28


def phase_kernels_deltam(device, reps):
    """P3 against its plain version at both c5 band-chunk shapes (one
    card's 1024 columns x 32 bands and the grid's 1024 x 36, 3 k-terms x
    32 layers), at 130 columns with a NaN in one lane's dtau and another's
    ssalb, and with delta-M off; the one-card shape's times are the
    kernels summary's."""
    from sbdart_tpu_torch.kernels.deltam_attenuation import (
        deltam_attenuation,
        deltam_attenuation_plain,
    )

    summary = {}
    cases = [(C5_COL_CHUNK, C5_BAND_CHUNK, True, True),
             (C5_COL_CHUNK, 36, True, True), (130, C5_BAND_CHUNK, True, False),
             (130, C5_BAND_CHUNK, False, False)]
    rows = []
    for ncol, nband, deltam, timed in cases:
        args = deltam_operands(device, ncol=ncol, nband=nband)
        if ncol == 130:
            args[0][3, 1, 2, 7] = float("nan")
            args[1][100, 5, 0, 0] = float("nan")

        def kern(a=args, dm=deltam):
            return deltam_attenuation(*a, dm)

        def plain(a=args, dm=deltam):
            return deltam_attenuation_plain(*a, dm)

        row = check_kernel("deltam_attenuation",
                           ("dtau", "ssalb", "gl", "eb", "eb_u"), kern,
                           plain, ncol, args)
        row.update(columns=ncol, bands=nband, deltam=deltam)
        if timed:
            time_kernel(row, kern, plain, reps, max(3, reps // 2))
        main = (ncol, nband) == (C5_COL_CHUNK, C5_BAND_CHUNK)
        fold(summary, row, main=main)
        rows.append(row)
    emit({"phase": "kernel", "path": "deltam", "k_terms": NK,
          "layers": NLYR - 1, "bar": KERNEL_BAR, "results": rows})
    return summary


def phase_kernels_fwd_rule(device, reps):
    """B6 forward's two designs at N = 2 and 3 on columns the reference
    streams (`reference_route`: N = 2 from 473 layers, N = 3 from 241), the
    shapes FWD_ONE_THREAD_N is read at: N = 2 at 480 layers x 49152
    columns (the nstr=4 flux cell's), N = 3 at 250 layers x 12288 (G4's),
    each against the plain version."""
    import torch

    from sbdart_tpu_torch.kernels.blocktri_rt_streamed import (
        FWD_ONE_THREAD_N, block_thomas_rt_fwd, block_thomas_rt_fwd_group,
        block_thomas_rt_fwd_plain, reference_route)

    summary = {}
    for n, nlyr in ((2, 480), (3, 250)):
        if n == 2:
            _, _, _, bvp = kernel_operands(flux_problem(NBC, NK, nlyr, device))
        else:
            bvp, _ = generic_kernel_operands(*generic_problem(
                4096, NK, nlyr, device, nstr=6, onlyfl=True,
                planck=True))["solve_bvp"]
        bvp = tuple(x.contiguous() for x in bvp)
        if reference_route(nlyr, n) != "streamed":
            raise SmokeFailure(f"N = {n} at {nlyr} layers is not B6's shape")
        rows = []
        for kname, kern in (("blocktri_rt_fwd", block_thomas_rt_fwd),
                            ("blocktri_rt_fwd_group",
                             block_thomas_rt_fwd_group)):
            row = check_kernel(kname, ("cs", "ys"), lambda k=kern: k(*bvp),
                               lambda: block_thomas_rt_fwd_plain(*bvp),
                               bvp[0].shape[-1], bvp)
            time_kernel(row, lambda k=kern: k(*bvp),
                        lambda: block_thomas_rt_fwd_plain(*bvp), reps, 1)
            # the one-thread design stands in the summary at N = 2
            fold(summary, row, main=n == 2 and kname == "blocktri_rt_fwd")
            rows.append(row)
        emit({"phase": "kernel", "path": "fwd_rule", "n": n, "layers": nlyr,
              "columns": bvp[0].shape[-1], "one_thread": n in FWD_ONE_THREAD_N,
              "bar": KERNEL_BAR, "results": rows})
        del bvp, rows
        torch.cuda.empty_cache()
    return summary


# the shapes at which the bwd_rule phase times B6 backward: (N, nstr,
# band-columns, layers, keywords of generic_problem, or None for the nstr=4
# flux cell's operands, "flux" for the flux path's at nstr, "random" for
# random_bvp's); x 3 k-terms.  N = 2 and 3 where the reference streams them
# (as fwd_rule), 8 the nstr16-flux-65L cell (65 x 6144), 10 G7's (65 x
# 6144), 16 G9's (its per-mode BVP, 65 x 768; here flux-only, the same
# shape).  Past N = 16, the run-time-N instance: N = 20 and 32 at 65 layers
# of 6144 and of 768 columns, and 64 at G10's deck (3 layers x 12 columns).
BWD_RULE = [(2, 4, NBC, 480, None),
            (3, 6, 4096, 250, dict(onlyfl=True, planck=True)),
            (8, 16, NBC16, NLYR16, "flux"),
            (10, 20, NBC16, NLYR16, dict(onlyfl=True)),
            (16, 32, NBC_RAD16, NLYR16, dict(onlyfl=True)),
            (20, 40, NBC16, NLYR16, "random"),
            (20, 40, NBC_RAD16, NLYR16, "random"),
            (32, 64, NBC16, NLYR16, "random"),
            (32, 64, NBC_RAD16, NLYR16, "random"),
            (64, 128, 4, 3, "random")]


def bwd_operands(case, device):
    """B6 backward's operands at one of BWD_RULE's shapes: the BVP's gp,
    gm, ee with a NaN in one column's right-hand side, and the history the
    forward kernel makes of it (equal to its plain version's: the other
    phases hold it so), as (gp, gm, ee, cs, ys)."""
    from sbdart_tpu_torch.kernels.blocktri_rt_streamed import (
        block_thomas_rt_fwd, reference_route)

    n, nstr, nbc, nlyr, kw = case
    if kw == "random":
        bvp = random_bvp(n, nlyr, nbc * NK, device)
    elif kw is None:
        bvp = kernel_operands(flux_problem(nbc, NK, nlyr, device))[3]
    elif kw == "flux":
        bvp = general_kernel_operands(flux_problem(
            nbc, NK, nlyr, device, nmom=nstr + 1), nstr)[1]
    else:
        bvp, _ = generic_kernel_operands(*generic_problem(
            nbc, NK, nlyr, device, nstr=nstr, **kw))["solve_bvp"]
    if reference_route(nlyr, n) != "streamed":
        raise SmokeFailure(f"N = {n} at {nlyr} layers is not B6's shape")
    bvp = with_nan(tuple(x.contiguous() for x in bvp))
    return bvp[:3] + tuple(block_thomas_rt_fwd(*bvp))


def phase_kernels_bwd_rule(device, reps):
    """B6 backward at each shape of BWD_RULE (the N BWD_ONE_THREAD_N is
    read at, and the run-time-N instance's placements) through its route,
    against the plain version (NaN column included) and timed.  The route
    runs the lane group kernel at every N (BWD_ONE_THREAD_N is empty: no
    one-thread backward kernel is built; `--ab` times the parent's
    one-thread kernel at these shapes)."""
    import torch

    from sbdart_tpu_torch.kernels.blocktri_rt_streamed import (
        BWD_ONE_THREAD_N, block_thomas_rt_bwd, block_thomas_rt_bwd_plain)

    summary = {}
    for case in BWD_RULE:
        n = case[0]
        ops = bwd_operands(case, device)

        def kern():
            return block_thomas_rt_bwd(*ops)

        def plain():
            return block_thomas_rt_bwd_plain(*ops)

        row = check_kernel("blocktri_rt_bwd_group", ("xs",), kern, plain,
                           ops[0].shape[-1], ops)
        time_kernel(row, kern, plain, reps, 1)
        # the kernels line: the nstr16-flux-65L cell's shape
        fold(summary, row, main=n == 8)
        emit({"phase": "kernel", "path": "bwd_rule", "n": n,
              "layers": ops[0].shape[0], "columns": ops[0].shape[-1],
              "one_thread": n in BWD_ONE_THREAD_N, "bar": KERNEL_BAR,
              "results": [row]})
        del ops, row
        torch.cuda.empty_cache()
    return summary


# the generic path's solve phases: (name, nstr, band-columns, layers,
# keywords of generic_problem)
GENERIC = {
    "G1": (16, NBC_RAD16, NLYR16, dict(onlyfl=False)),
    "G2": (8, NBC16, NLYR, dict(onlyfl=False)),
    "G3": (4, 4096, NLYR, dict(onlyfl=False)),
    "G4": (6, 4096, NLYR, dict(onlyfl=True, planck=True)),
    "G5": (10, NBC_RAD16, NLYR, dict(onlyfl=False, angles=True)),
    "G6": (8, NBC16, NLYR, dict(onlyfl=True, brdf=True)),
    "G7": (20, NBC16, NLYR16, dict(onlyfl=True)),
    "G8": (18, NBC16, NLYR, dict(onlyfl=True)),
    "G9": (32, NBC_RAD16, NLYR16, dict(onlyfl=False, angles=True)),
    # past the shared memory of one column: the group kernels' far
    # instances on a short deck
    "G10": (128, 4, 3, dict(onlyfl=True)),
}


def generic_operands(name, device):
    """The generic path's kernel operands at one of its solve shapes."""
    nstr, nbc, nlyr, kw = GENERIC[name]
    return generic_kernel_operands(*generic_problem(
        nbc, NK, nlyr, device, nstr=nstr, **kw))


def phase_kernels_generic(device, reps):
    """The generic path's kernels against their plain versions on the
    operands the path gives them: B9 on the all-mode lanes of G1 (N = 8,
    16 modes x 65 layers x 768 columns), G2 (N = 4) and G3 (N = 2) and on
    130 lanes (at N >= 4 with a NaN in one lane's C^pp); B10 (the design
    block_thomas routes m = 8 to) on solver/bvp.py:assemble_blocks of G2's
    BVP (m = 8, 33 layers x 49152 columns) and on 130 columns; B5 and B6
    at odd N on G4's (N = 3, 12288 columns) and G5's (N = 5, 7680 columns)
    BVP and on 130 columns."""
    import torch

    from sbdart_tpu_torch.kernels.blocktri import (
        block_thomas, block_thomas_plain)
    from sbdart_tpu_torch.kernels.blocktri_rt_streamed import (
        block_thomas_rt_fwd_plain)
    from sbdart_tpu_torch.kernels.eig_chain import eig_chain, eig_chain_plain
    from sbdart_tpu_torch.solver.bvp import assemble_blocks

    summary = {}
    for name in ("G1", "G2", "G3", "G4", "G5"):
        ops = generic_operands(name, device)
        calls = {}
        if "eig_chain_lane" in ops:
            (cppl, cpml, mu, w), _ = ops["eig_chain_lane"]
            flat = tuple(x[None].contiguous() for x in (cppl, cpml))
            del cppl, cpml
            for lanes in (flat[0].shape[-1], 130):
                sl = tuple(x[..., :lanes].contiguous() for x in flat)
                if lanes == 130 and flat[0].shape[1] >= 4:
                    sl = (with_nan_lane(sl[0]), sl[1])
                calls[("eig_chain", lanes)] = (
                    ("kk", "gp", "gm"),
                    lambda sl=sl: eig_chain(*sl, mu, w),
                    lambda sl=sl: eig_chain_plain(*sl, mu, w), 2, sl)
        bvp, _ = ops["solve_bvp"]
        del ops
        if name == "G2":
            gp, gm, ee, refl, rhs = bvp
            # an exact float32 beam resonance (k = 1/mu0 at a column's
            # no-beam dither) leaves a column's rhs non-finite, on the
            # reference's route too: hold the finite columns
            keep = torch.isfinite(rhs).all(dim=0).all(dim=0)
            blocks = tuple(x[..., keep].contiguous() for x in
                           (*assemble_blocks(gp, gm, ee, refl), rhs))
            for cols in (blocks[0].shape[-1], 130):
                sl = tuple(x[..., :cols].contiguous() for x in blocks)
                calls[(bt_kernel(blocks[0].shape[1]), cols)] = (
                    ("xs",), lambda sl=sl: block_thomas(*sl),
                    lambda sl=sl: block_thomas_plain(*sl), 2, sl)
            del blocks
        elif name in ("G4", "G5"):
            for cols in (bvp[0].shape[-1], 130):
                sl = tuple(x[..., :cols].contiguous() for x in bvp)
                hist = block_thomas_rt_fwd_plain(*sl)
                for kname, call in bvp_calls(sl, hist).items():
                    calls[(kname, cols)] = call
        del bvp
        rows = []
        main = {"eig_chain": "G1", "block_thomas_group": "G2"}
        for (kname, cols), (names, kern, plain, plain_reps, args) in \
                calls.items():
            row = check_kernel(kname, names, kern, plain, cols, args)
            row.update(shape=name, columns=cols,
                       n=int(args[0].shape[1]) // (
                           2 if kname.startswith("block_thomas") else 1))
            if cols != 130:
                time_kernel(row, kern, plain, reps, plain_reps)
            fold(summary, row, main=cols != 130 and main.get(kname) == name)
            rows.append(row)
        emit({"phase": "kernel", "path": "generic", "shape": name,
              "bar": KERNEL_BAR, "results": rows})
        del calls, rows
        torch.cuda.empty_cache()
    return summary


def with_nan_lane(cppl):
    """A copy of B9's C^pp [L, N, N, lanes] with a NaN in one lane."""
    cppl = cppl.clone()
    cppl[0, 0, 0, cppl.shape[-1] // 2] = float("nan")
    return cppl


def with_nan(ops):
    """A copy of BVP operands (..., rhs) with a NaN in one column's
    right-hand side, layer 1 (the float32 beam resonance's pattern)."""
    rhs = ops[-1].clone()
    rhs[min(1, rhs.shape[0] - 1), 0, rhs.shape[-1] // 2] = float("nan")
    return tuple(ops[:-1]) + (rhs,)


# the group kernels' shapes past N = 8: (name, nstr, band-columns,
# layers); x 3 k-terms, fluxes, so the BVP has 3 x band-columns columns
GROUP_SHAPES = [("G7", 20, NBC16, NLYR16), ("N16", 32, NBC16, NLYR16),
                ("G8", 18, NBC16, NLYR), ("N20", 40, NBC16, 6)]


def phase_kernels_group(device, reps):
    """The group-per-column kernels past N = 8 against their plain versions
    on the generic path's BVP operands, each at the shape's columns with a
    NaN injected in one column's right-hand side, and at 130 columns: B6
    forward and backward at N = 10 (G7: 65 layers x 6144) and N = 16 (65 x
    6144), B10 on G7's assembled blocks (m = 20), B5 at N = 9 (G8: 33 x
    6144) and N = 20 (6 x 6144, the reference's B5 limit there)."""
    import torch

    from sbdart_tpu_torch.kernels.blocktri import (
        block_thomas_group, block_thomas_plain)
    from sbdart_tpu_torch.kernels.blocktri_rt import (
        block_thomas_rt_group, block_thomas_rt_plain)
    from sbdart_tpu_torch.kernels.blocktri_rt_streamed import (
        block_thomas_rt_bwd_group, block_thomas_rt_bwd_plain,
        block_thomas_rt_fwd_group, block_thomas_rt_fwd_plain)
    from sbdart_tpu_torch.solver.bvp import assemble_blocks

    summary = {}
    # the shapes whose times stand in the kernels summary are elsewhere:
    # B6's at N = 8 (phase_kernels_general, and backward's bwd_rule), B5's
    # group kernel's at N = 4 (rt_rule), B10's group kernel's G2, m = 8
    # (phase_kernels_generic)
    for name, nstr, nbc, nlyr in GROUP_SHAPES:
        bvp, _ = generic_kernel_operands(*generic_problem(
            nbc, NK, nlyr, device, nstr=nstr, onlyfl=True))["solve_bvp"]
        calls = {}
        for cols in (bvp[0].shape[-1], 130):
            sl = tuple(x[..., :cols].contiguous() for x in bvp)
            if cols != 130:
                sl = with_nan(sl)
            if nlyr == NLYR16:
                hist = block_thomas_rt_fwd_plain(*sl)
                calls[("blocktri_rt_fwd_group", cols)] = (
                    ("cs", "ys"), lambda sl=sl: block_thomas_rt_fwd_group(*sl),
                    lambda sl=sl: block_thomas_rt_fwd_plain(*sl), 2, sl)
                calls[("blocktri_rt_bwd_group", cols)] = (
                    ("xs",),
                    lambda sl=sl, h=hist: block_thomas_rt_bwd_group(*sl[:3],
                                                                    *h),
                    lambda sl=sl, h=hist: block_thomas_rt_bwd_plain(*sl[:3],
                                                                    *h),
                    2, sl[:3] + tuple(hist))
            else:
                calls[("blocktri_rt_group", cols)] = (
                    ("xs",), lambda sl=sl: block_thomas_rt_group(*sl),
                    lambda sl=sl: block_thomas_rt_plain(*sl), 2, sl)
            if name == "G7":
                blocks = tuple(x.contiguous() for x in
                               (*assemble_blocks(*sl[:4]), sl[4]))
                calls[("block_thomas_group", cols)] = (
                    ("xs",), lambda b=blocks: block_thomas_group(*b),
                    lambda b=blocks: block_thomas_plain(*b), 2, blocks)
        del bvp
        rows = []
        for (kname, cols), (names, kern, plain, plain_reps, args) in \
                calls.items():
            row = check_kernel(kname, names, kern, plain, cols, args)
            row.update(shape=name, columns=cols, layers=nlyr,
                       m=int(args[0].shape[1]) * (
                           1 if kname == "block_thomas_group" else 2))
            if cols != 130:
                time_kernel(row, kern, plain, reps, plain_reps)
            fold(summary, row, main=False)
            rows.append(row)
        emit({"phase": "kernel", "path": "group", "shape": name,
              "nstr": nstr, "bar": KERNEL_BAR, "results": rows})
        del calls, rows
        torch.cuda.empty_cache()
    return summary


def rt_operands(n, device):
    """B5's operands at the shape the main path gives it at N = n: N = 2
    the nstr=4 flux cell at 65 layers (65 x 49152), 3 G4's (33 x 12288),
    4 the nstr=8 flux BVP (33 x 6144, as G6's), 5 G5's (33 x 7680), 8
    BASELINE config 3's chunk (32 layers x 48 wavelengths x 3 k-terms);
    N = 1, which no phase runs, nstr=2 fluxes on G4's columns."""
    if n == 1:
        return generic_kernel_operands(*generic_problem(
            4096, NK, NLYR, device, nstr=2, onlyfl=True))["solve_bvp"][0]
    if n == 2:
        return kernel_operands(flux_problem(NBC, NK, 65, device))[3]
    if n in (3, 5):
        return generic_operands({3: "G4", 5: "G5"}[n], device)[
            "solve_bvp"][0]
    nbc, nlyr = {4: (NBC16, NLYR), 8: (48, 32)}[n]
    prob = flux_problem(nbc, NK, nlyr, device, nmom=2 * n + 1)
    return general_kernel_operands(prob, 2 * n)[1]


# the N at which the rt_rule phase times B5's two designs
RT_RULE_N = (1, 2, 3, 4, 5, 8)


def phase_kernels_rt_rule(device, reps):
    """B5's two designs at each N the main path sends it (RT_RULE_N, at
    rt_operands' shapes), each against the plain version and timed: the
    group kernel always, the one-thread kernel where it is built (the N of
    RT_ONE_THREAD_N), the shapes RT_ONE_THREAD_N is read at."""
    import torch

    from sbdart_tpu_torch.kernels.blocktri_rt import (
        RT_ONE_THREAD_N, block_thomas_rt, block_thomas_rt_group,
        block_thomas_rt_plain)

    summary = {}
    for n in RT_RULE_N:
        bvp = tuple(x.contiguous() for x in rt_operands(n, device))
        calls = {"blocktri_rt_group": (block_thomas_rt_group, 1)}
        if n in RT_ONE_THREAD_N:
            calls["blocktri_rt"] = (block_thomas_rt, 1)
        rows = []
        for kname, (wrapper, plain_reps) in calls.items():
            def kern(w=wrapper):
                return w(*bvp)

            def plain():
                return block_thomas_rt_plain(*bvp)

            row = check_kernel(kname, ("xs",), kern, plain,
                               bvp[0].shape[-1], bvp)
            time_kernel(row, kern, plain, reps, plain_reps)
            row["on_main_path"] = kname == rt_kernel(n)
            # the kernels line: the group kernel at N = 4, the one-thread
            # kernel at N = 2 (the nstr=4 flux cell at 65 layers)
            fold(summary, row, main=(n, kname) in (
                (4, "blocktri_rt_group"), (2, "blocktri_rt")))
            rows.append(row)
        emit({"phase": "kernel", "path": "rt_rule", "n": n,
              "layers": bvp[0].shape[0], "columns": bvp[0].shape[-1],
              "one_thread": n in RT_ONE_THREAD_N, "bar": KERNEL_BAR,
              "results": rows})
        del bvp, rows
        torch.cuda.empty_cache()
    return summary


# the m at which the bt_rule phase times B10's two designs, and the
# generic path's shape there: (nstr, band-columns, layers, keywords of
# generic_problem); x 3 k-terms.  m = 8 is "G2, scan" (33 x 49152), 18
# "G8, scan" (33 x 6144), 4 and 16 the scan route at nstr 4 (all modes,
# 33 x 49152) and 16 (all modes, 65 x 6144; fluxes at nstr 16 take the
# lane path), 2 at nstr 2 (fluxes, 33 x 12288).
BT_RULE = {2: (2, 4096, NLYR, dict(onlyfl=True)),
           4: (4, 4096, NLYR, dict(onlyfl=False)),
           8: (8, NBC16, NLYR, dict(onlyfl=False)),
           16: (16, 128, NLYR16, dict(onlyfl=False)),
           18: (18, NBC16, NLYR, dict(onlyfl=True))}


def bt_operands(m, device):
    """B10's operands at the shape the scan route gives it at block size
    m (BT_RULE): solver/bvp.py:assemble_blocks of the generic path's BVP,
    its finite columns (a float32 beam resonance can leave a column's rhs
    non-finite, on the reference's route too), with a NaN injected in one
    column's right-hand side."""
    import torch

    from sbdart_tpu_torch.solver.bvp import assemble_blocks

    nstr, nbc, nlyr, kw = BT_RULE[m]
    (gp, gm, ee, refl, rhs), _ = generic_kernel_operands(*generic_problem(
        nbc, NK, nlyr, device, nstr=nstr, **kw))["solve_bvp"]
    keep = torch.isfinite(rhs).all(dim=0).all(dim=0)
    return with_nan(tuple(x[..., keep].contiguous() for x in
                          (*assemble_blocks(gp, gm, ee, refl), rhs)))


def phase_kernels_bt_rule(device, reps):
    """B10's two designs at each m of BT_RULE, each against the plain
    version (NaN column included) and timed: the group kernel always, the
    one-thread kernel where it is built (the m of BT_ONE_THREAD_M), the
    shapes BT_ONE_THREAD_M is read at."""
    import torch

    from sbdart_tpu_torch.kernels.blocktri import (
        BT_ONE_THREAD_M, block_thomas, block_thomas_group, block_thomas_plain)

    summary = {}
    for m in BT_RULE:
        blocks = bt_operands(m, device)
        calls = {"block_thomas_group": block_thomas_group}
        if m in BT_ONE_THREAD_M:
            calls["block_thomas"] = block_thomas
        rows = []
        for kname, wrapper in calls.items():
            def kern(w=wrapper):
                return w(*blocks)

            def plain():
                return block_thomas_plain(*blocks)

            row = check_kernel(kname, ("xs",), kern, plain,
                               blocks[0].shape[-1], blocks)
            time_kernel(row, kern, plain, reps, 1)
            row["on_main_path"] = kname == bt_kernel(m)
            # the kernels line: the one-thread kernel at the m it runs
            fold(summary, row, main=kname == "block_thomas" and m == min(
                BT_ONE_THREAD_M, default=0))
            rows.append(row)
        emit({"phase": "kernel", "path": "bt_rule", "m": m,
              "layers": blocks[0].shape[0], "columns": blocks[0].shape[-1],
              "one_thread": m in BT_ONE_THREAD_M, "bar": KERNEL_BAR,
              "results": rows})
        del blocks, rows
        torch.cuda.empty_cache()
    return summary


def random_bvp(n, nlyr, ncol, device, seed=0):
    """Random B5/B6 operands (gp, gm, ee, refl, rhs) on the card, the
    systems of tests/test_torch_kernels_cuda.py:_bvp_operands, with a NaN
    in one column's right-hand side."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    eye = torch.eye(n, device=device)[None, :, :, None]
    gm = 2.0 * eye + 0.3 * torch.randn((nlyr, n, n, ncol), generator=gen,
                                       device=device)
    gp = 0.4 * torch.randn((nlyr, n, n, ncol), generator=gen, device=device)
    ee = u(0.05, 0.8, nlyr, n, ncol)
    refl = u(0.0, 0.3, n, n, ncol)
    rhs = torch.randn((nlyr, 2 * n, ncol), generator=gen, device=device)
    return with_nan((gp, gm, ee, refl, rhs))


def group_limits(device):
    """For each group kernel with a far instance: the first N (m for B10)
    whose whole column exceeds the card's opt-in shared memory (the
    limit before the far placement) and the first whose system alone
    does (the limit now), from its *_bytes entry point."""
    import torch

    from sbdart_tpu_torch.kernels import _build

    lib = _build.library()
    optin = torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin

    def first(column_bytes):
        size = 1
        while column_bytes(size) <= optin:
            size += 1
        return size

    rt, st, bt = (lib.sbdart_blocktri_rt_group_bytes,
                  lib.sbdart_blocktri_rt_streamed_group_bytes,
                  lib.sbdart_block_thomas_group_bytes)
    bwd = lib.sbdart_blocktri_rt_bwd_group_bytes
    return optin, {
        "blocktri_rt_group": (first(lambda n: rt(n, 0)),
                              first(lambda n: rt(n, 1))),
        "blocktri_rt_fwd_group": (first(lambda n: st(0, n)),
                                  first(lambda n: st(2, n))),
        "blocktri_rt_bwd_group": (first(bwd), first(bwd)),
        "block_thomas_group": (first(lambda m: bt(m, 0)),
                               first(lambda m: bt(m, 1))),
    }


def phase_kernels_far(device):
    """The group kernels past the N whose whole column fills the card's
    shared memory (their far instances: the system in shared memory, the
    rest in device scratch): the limits before and now, then B5, B6
    forward (and backward on its plain history) and B10 against their
    plain versions at the first N the old layout refused and at nstr =
    128 (N = 64, m = 128), 3 layers x 3 columns with a NaN column."""
    import torch

    from sbdart_tpu_torch.kernels.blocktri import (
        block_thomas_group, block_thomas_plain)
    from sbdart_tpu_torch.kernels.blocktri_rt import (
        block_thomas_rt_group, block_thomas_rt_plain)
    from sbdart_tpu_torch.kernels.blocktri_rt_streamed import (
        block_thomas_rt_bwd_group, block_thomas_rt_bwd_plain,
        block_thomas_rt_fwd_group, block_thomas_rt_fwd_plain)
    from sbdart_tpu_torch.solver.bvp import assemble_blocks

    optin, limits = group_limits(device)
    emit({"phase": "shared_memory", "optin_bytes": optin,
          "first_refused_whole_column": {k: v[0] for k, v in limits.items()},
          "first_refused_now": {k: v[1] for k, v in limits.items()}})
    summary = {}
    rows = []
    cases = [("blocktri_rt_group", limits["blocktri_rt_group"][0]),
             ("blocktri_rt_group", 64),
             ("blocktri_rt_fwd_group", limits["blocktri_rt_fwd_group"][0]),
             ("blocktri_rt_fwd_group", 64),
             ("block_thomas_group", limits["block_thomas_group"][0]),
             ("block_thomas_group", 128)]
    for kname, size in cases:
        if kname == "block_thomas_group":
            ops = random_bvp((size + 1) // 2, 3, 3, device)
            blocks = tuple(x.contiguous() for x in
                           (*assemble_blocks(*ops[:4]), ops[4]))
            calls = {kname: (("xs",), lambda b=blocks: block_thomas_group(*b),
                             lambda b=blocks: block_thomas_plain(*b))}
        else:
            ops = random_bvp(size, 3, 3, device)
            if kname == "blocktri_rt_group":
                calls = {kname: (("xs",), lambda: block_thomas_rt_group(*ops),
                                 lambda: block_thomas_rt_plain(*ops))}
            else:
                hist = block_thomas_rt_fwd_plain(*ops)
                calls = {
                    kname: (("cs", "ys"),
                            lambda: block_thomas_rt_fwd_group(*ops),
                            lambda: block_thomas_rt_fwd_plain(*ops)),
                    "blocktri_rt_bwd_group": (
                        ("xs",),
                        lambda: block_thomas_rt_bwd_group(*ops[:3], *hist),
                        lambda: block_thomas_rt_bwd_plain(*ops[:3], *hist)),
                }
        for k, (names, kern, plain) in calls.items():
            row = check_kernel(k, names, kern, plain, 3)
            row.update(size=size, layers=3, columns=3,
                       far=size >= limits[k][0])
            fold(summary, row, main=False)
            rows.append(row)
        torch.cuda.synchronize()
    emit({"phase": "kernel", "path": "far", "bar": KERNEL_BAR,
          "results": rows})
    return summary


RADIANCE_CELLS = {
    "nstr16-rad-65L/256": dict(nbc=NBC_RAD16, nlyr=NLYR16, nstr=16),
    "nstr16-rad-65L/2048": dict(nbc=NBC16, nlyr=NLYR16, nstr=16),
    "nstr4-rad-33L": dict(nbc=4096, nlyr=NLYR, nstr=4),
    "nstr8-brdf-thermal-33L": dict(nbc=512, nlyr=NLYR, nstr=8, planck=True,
                                   brdf=True),
}


FLUX_CELLS = {   # name: (nstr, band-columns, layers, Planck)
    "nstr4-flux-33L": (4, NBC, NLYR, False),
    "nstr16-flux-65L": (16, NBC16, NLYR16, False),
    "nstr4-thermal-33L": (4, NBC, NLYR, True),
    "nstr4-flux-65L": (4, NBC, 65, False),
}


def solve_cell(name, device, seed=0, small=False):
    """The solve_rte request of one cell of PERF.md section 4 (FLUX_CELLS,
    RADIANCE_CELLS, GENERIC; a "-scan" suffix asks for bvp_method "scan"),
    from `seed`: (route, nstr, (dtau, ssalb, pmom), the keywords of the
    float32 kernel path).  `small` cuts the band-columns to 64 at most
    (the card's tests)."""
    import torch

    from sbdart_tpu_torch.solver.disort import route

    base = name.removesuffix("-scan")
    extra = dict(bvp_method="scan" if name.endswith("-scan") else "auto",
                 eig_method="auto", dtype=torch.float32)
    if base in FLUX_CELLS:
        nstr, nbc, nlyr, planck = FLUX_CELLS[base]
        prob = flux_problem(min(nbc, 64) if small else nbc, NK, nlyr, device,
                            seed=seed, nmom=nstr + 1, planck=planck)
        args = (prob.pop("dtau"), prob.pop("ssalb"), prob.pop("pmom"))
        kw = dict(nstr=nstr, onlyfl=True, **prob)
    elif base in RADIANCE_CELLS:
        cell = dict(RADIANCE_CELLS[base])
        if small:
            cell["nbc"] = min(cell["nbc"], 64)
        args, kw = radiance_problem(device=device, seed=seed, **cell)
    else:
        nstr, nbc, nlyr, pkw = GENERIC[base]
        args, kw = generic_problem(min(nbc, 64) if small else nbc, NK, nlyr,
                                   device, nstr=nstr, seed=seed, **pkw)
    kw.update(extra)
    path = route(nstr=kw["nstr"], onlyfl=kw["onlyfl"], brdf=kw.get("brdf"),
                 umu=kw.get("umu"), phi=kw.get("phi"))
    return path, kw["nstr"], args, kw


def captured_solve(args, kw, inputs_only=False):
    """solve_rte on (args, kw) as an ops/graph.py:CapturedCall, its inputs
    the tensors among them (the rest static), captured where the rule
    admits the request: (call, inputs), or the inputs alone."""
    import torch

    from sbdart_tpu_torch.ops.graph import CapturedCall
    from sbdart_tpu_torch.solver.disort import graph_ok, route, solve_rte

    inputs = dict(zip(("dtauc", "ssalb", "pmom"), args))
    inputs.update((k, v) for k, v in kw.items()
                  if isinstance(v, torch.Tensor))
    if inputs_only:
        return inputs
    static = {k: v for k, v in kw.items() if k not in inputs}
    path = route(nstr=kw["nstr"], onlyfl=kw["onlyfl"], brdf=kw.get("brdf"),
                 umu=kw.get("umu"), phi=kw.get("phi"))
    capture = graph_ok(path, kw["nstr"], kw.get("dtype", torch.float32),
                       args[0].device)
    return CapturedCall(lambda **x: solve_rte(**x, **static),
                        capture=capture), inputs


def eager_solve(args, kw):
    """solve_rte on (args, kw), eagerly on the current stream."""
    from sbdart_tpu_torch.solver.disort import solve_rte

    return solve_rte(*args, **kw)


@contextlib.contextmanager
def eager_only():
    """run_pipeline and build_batch_fn with capture ruled out (graph_ok
    false in both modules), and _captured_solver's cache emptied on the way
    in and out: the eager runs the captured ones are held to."""
    from sbdart_tpu_torch import batch, pipeline

    saved = pipeline.graph_ok, batch.graph_ok
    pipeline._captured_solver.cache_clear()
    pipeline.graph_ok = batch.graph_ok = lambda *a: False
    try:
        yield
    finally:
        pipeline.graph_ok, batch.graph_ok = saved
        pipeline._captured_solver.cache_clear()


@contextlib.contextmanager
def recording_calls(module):
    """The CapturedCalls `module` (pipeline or batch) makes meanwhile, in
    a list."""
    from sbdart_tpu_torch.ops.graph import CapturedCall

    made = []

    class Recording(CapturedCall):
        def __init__(self, fn, *, capture):
            super().__init__(fn, capture=capture)
            made.append(self)

    saved = module.CapturedCall
    module.CapturedCall = Recording
    try:
        yield made
    finally:
        module.CapturedCall = saved


def bit_diff(got, want) -> tuple[float, bool]:
    """(max |got - want| / max |want| over the finite elements, whether
    the NaN positions agree): (0.0, True) is equality to the bit."""
    import numpy as np
    import torch

    g = got.detach().double().cpu().numpy() if isinstance(
        got, torch.Tensor) else np.asarray(got, np.float64)
    w = want.detach().double().cpu().numpy() if isinstance(
        want, torch.Tensor) else np.asarray(want, np.float64)
    nan_ok = g.shape == w.shape and bool(np.array_equal(np.isnan(g),
                                                        np.isnan(w)))
    if not nan_ok:
        return float("inf"), False
    fin = ~np.isnan(w)
    if not fin.any():
        return 0.0, True
    scale = max(float(np.abs(w[fin]).max()), 1e-300)
    return float(np.abs(g[fin] - w[fin]).max()) / scale, True


def outputs_diff(got, want) -> dict:
    """bit_diff of each field of two RteOutputs (or SpectralResults):
    {field: rel_err}, NaN positions that disagree as inf."""
    out = {}
    for f in ("rfldir", "rfldn", "flup", "dfdt", "uavg", "uu", "fdir",
              "fdn", "fup"):
        a, b = getattr(got, f, None), getattr(want, f, None)
        if a is None and b is None:
            continue
        if (a is None) != (b is None):
            out[f] = float("inf")
            continue
        err, nan_ok = bit_diff(a, b)
        out[f] = err if nan_ok else float("inf")
    return out


def kernel_launches() -> dict:
    """{wrapper: launches so far} from the kernel wrappers' process
    counters (`kernels.<wrapper>.launches`, sbdart_tpu_torch/tracing.py)."""
    from sbdart_tpu_torch import tracing

    return {k.split(".")[1]: v for k, v in tracing.counters().items()
            if k.startswith("kernels.")}


def graph_check(cell, path, nstr, call, inputs, eager, rec, reps, owned,
                reason):
    """One cell's "graph" line.  Where the rule leaves the route eager
    (`reason`): "graph": false and the reason.  Else `call` (its eager
    warm-up done, giving `eager`) captures and replays on the same inputs,
    then replays fresh inputs (the cell at seed 1) against a fresh eager
    solve, both to the bit, NaN positions too; the replays must move the
    launch counters of the kernels in `owned`; then the replay's wall
    (CUDA events) and device busy (profiler) beside the eager solve's
    (`rec`, the cell's solve line), the graph's node count, its capture
    and instantiate seconds and its pool's bytes."""
    import torch

    if reason is not None:
        emit({"phase": "graph", "cell": cell, "route": path, "nstr": nstr,
              "graph": False, "reason": reason})
        return
    before = kernel_launches()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    got = call(inputs)                      # capture, instantiate, replay
    torch.cuda.synchronize()
    same = outputs_diff(got, eager)
    del got, eager
    moved = {k: v - before.get(k, 0) for k, v in kernel_launches().items()
             if v != before.get(k, 0)}
    names = {KERNELS[k][1]: k for k in KERNELS}
    missed = [k for k in owned if KERNELS[k][1] not in moved]
    _, _, f_args, f_kw = solve_cell(cell, inputs["dtauc"].device, seed=1)
    want = eager_solve(f_args, f_kw)
    start.record()
    got = call(captured_solve(f_args, f_kw, inputs_only=True))
    stop.record()
    stop.synchronize()
    fresh = outputs_diff(got, want)
    del got, want, f_args, f_kw
    if reps > 1:
        r_ms = timed_ms(lambda: call(inputs), reps, warmup=1)
    else:
        r_ms = start.elapsed_time(stop)
    busy = device_ms(lambda: call(inputs), max(1, reps // 2))
    e_ms, e_busy = rec["kernel_path_ms"], rec["kernel_path_device_busy_ms"]
    out = {"phase": "graph", "cell": cell, "route": path, "nstr": nstr,
           "graph": True, "rel_err": same, "fresh_rel_err": fresh,
           "bar": 0.0, "eager_ms": e_ms, "replay_ms": r_ms,
           "eager_device_busy_ms": e_busy, "replay_device_busy_ms": busy,
           "eager_idle_share": (None if e_busy is None
                                else max(0.0, 1.0 - e_busy / e_ms)),
           "replay_idle_share": (None if busy is None
                                 else max(0.0, 1.0 - busy / r_ms)),
           "nodes": call.node_count(), "capture_s": call.capture_s,
           "instantiate_s": call.instantiate_s,
           "pool_bytes": call.pool_bytes,
           "replay_launches": {names.get(k, k): v for k, v in moved.items()}}
    emit(out)
    del call
    torch.cuda.empty_cache()
    bad = {k: v for k, v in {**same, **{f"fresh_{k}": v for k, v in
                                         fresh.items()}}.items() if v != 0.0}
    if bad:
        raise SmokeFailure(f"graph {cell}: replay differs from eager {bad}")
    if missed:
        raise SmokeFailure(f"graph {cell}: the replay launched none of "
                           f"{missed}")


def phase_generic(device, reps, name, bar=E2E_BAR, owned=()):
    """solve_rte on the generic path in float32 through the kernels
    against its plain path on the card, at one of GENERIC's shapes (a
    "-scan" name: bvp_method "scan", the assembled-block route, B10): the
    fluxes (and uu where asked) within `bar` of each field's max (0.0: the
    same numbers), timed; then the same solve captured and replayed where
    the rule admits it (`graph_check`)."""
    import torch

    from sbdart_tpu_torch.solver.disort import eager_reason, solve_rte

    path, nstr, args, kw = solve_cell(name, device)
    if path != "generic":
        raise SmokeFailure(f"{name}: not a generic-path request")
    nbc, _, nlyr = args[0].shape
    bvp_method = kw["bvp_method"]
    call, inputs = captured_solve(args, kw)

    def run(method):
        return solve_rte(*args, **dict(kw, eig_method=method))

    out_k = call(inputs)            # the eager warm-up where it is captured
    out_p = run("plain")
    errs = {}
    fields = ("rfldn", "flup", "uavg", "dfdt")
    fields += ("uu",) if "umu" in kw else ()
    for field in ("rfldir",) + fields:
        a, b = getattr(out_k, field), getattr(out_p, field)
        if not (bool(torch.isfinite(a).all())
                and bool(torch.isfinite(b).all())):
            raise SmokeFailure(f"{name} {field}: non-finite output")
        errs[field] = float((a - b).abs().max()
                            / b.abs().max().clamp_min(1e-9))
    if tuple(out_k.flup.shape) != (nbc, NK, nlyr + 1):
        raise SmokeFailure(f"{name}: flup shape {tuple(out_k.flup.shape)}")
    if ("umu" in kw) != (out_k.uu is not None):
        raise SmokeFailure(f"{name}: uu {out_k.uu is not None}")
    worst = max(errs[f] for f in fields)
    # reps = 1 (the solves past N = 8, seconds each): the runs above were
    # the warm-ups; one timed run of each path follows, and one profiled
    k_ms = timed_ms(lambda: run("auto"), reps, warmup=2 if reps > 1 else 0)
    p_ms = timed_ms(lambda: run("plain"), min(2, reps), warmup=0)
    dev = device_breakdown(lambda: run("auto"),
                           max(2, reps // 2) if reps > 1 else 1,
                           warmup=reps > 1)
    busy_ms = dev["device_busy_ms"]
    rec = {"phase": "solve", "kind": "generic", "cell": name.split("-")[0],
           "bvp_method": bvp_method, "nstr": nstr,
           "onlyfl": kw["onlyfl"], "angles": "umu" in kw,
           "planck": bool(kw.get("planck")),
           "brdf": "hapke" if "brdf" in kw else None,
           "band_columns": nbc, "k_terms": NK, "layers": nlyr,
           "dtype": "float32", "rel_err": errs, "bar": bar,
           "kernel_path_ms": k_ms, "plain_path_ms": p_ms,
           "kernel_path_bc_per_s": nbc / (k_ms / 1e3),
           "plain_path_bc_per_s": nbc / (p_ms / 1e3),
           "kernel_path_device_busy_ms": busy_ms,
           "kernel_path_device_idle_share": (
               None if busy_ms is None else max(0.0, 1.0 - busy_ms / k_ms)),
           "kernel_path_kernel_device_ms": dev["kernel_device_ms"],
           "kernel_path_glue_device_ms": dev["glue_device_ms"],
           "kernel_path_device_ops": dev["device_ops_per_solve"]}
    emit(rec)
    if worst > bar:
        raise SmokeFailure(f"{name}: kernel vs plain path {worst:.3g} > "
                           f"{bar}")
    del out_p
    graph_check(name, path, nstr, call, inputs, out_k, rec, reps, owned,
                eager_reason(path, nstr, kw["dtype"], device))
    return rec


def phase_radiance(device, reps, cell, owned=()):
    """solve_rte(onlyfl=False) through the kernels against the plain path
    on the card at one of RADIANCE_CELLS, timed: uu and the fluxes within
    5e-4 of each field's max; then the same solve captured and replayed
    (`graph_check`)."""
    import torch

    from sbdart_tpu_torch.solver.disort import eager_reason, solve_rte

    path, nstr, args, kw = solve_cell(cell, device)
    nbc, nlyr = args[0].shape
    planck, brdf = bool(kw.get("planck")), "brdf" in kw
    call, inputs = captured_solve(args, kw)

    def run(method):
        return solve_rte(*args, **dict(kw, eig_method=method))

    out_k = call(inputs)            # the eager warm-up of the captured call
    out_p = run("plain")
    errs = {}
    for name in ("uu", "rfldir", "rfldn", "flup", "uavg", "dfdt"):
        a, b = getattr(out_k, name), getattr(out_p, name)
        if not (bool(torch.isfinite(a).all())
                and bool(torch.isfinite(b).all())):
            raise SmokeFailure(f"radiance {name}: non-finite output")
        errs[name] = float((a - b).abs().max() / b.abs().max().clamp_min(1e-9))
    if tuple(out_k.uu.shape) != (nbc, nlyr + 1, len(UMU_VIEW), len(PHI_VIEW)):
        raise SmokeFailure(f"radiance uu: shape {tuple(out_k.uu.shape)}")
    worst = max(errs[n] for n in ("uu", "rfldn", "flup", "uavg", "dfdt"))
    k_ms = timed_ms(lambda: run("auto"), reps)
    p_ms = timed_ms(lambda: run("plain"), 2, warmup=0)
    dev = device_breakdown(lambda: run("auto"), max(2, reps // 2))
    busy_ms = dev["device_busy_ms"]
    rec = {"phase": "solve", "kind": "radiance", "cell": cell, "nstr": nstr,
           "planck": planck, "brdf": "hapke" if brdf else None,
           "band_columns": nbc, "layers": nlyr, "umu": list(UMU_VIEW),
           "phi": list(PHI_VIEW), "dtype": "float32", "rel_err": errs,
           "bar": E2E_BAR, "kernel_path_ms": k_ms, "plain_path_ms": p_ms,
           "kernel_path_bc_per_s": nbc / (k_ms / 1e3),
           "plain_path_bc_per_s": nbc / (p_ms / 1e3),
           "kernel_path_device_busy_ms": busy_ms,
           "kernel_path_device_idle_share": (
               None if busy_ms is None else max(0.0, 1.0 - busy_ms / k_ms)),
           "kernel_path_kernel_device_ms": dev["kernel_device_ms"],
           "kernel_path_glue_device_ms": dev["glue_device_ms"],
           "kernel_path_device_ops": dev["device_ops_per_solve"],
           "kernel_path_copy_ops": dev["copy_ops_per_solve"],
           "kernel_path_copy_device_ms": dev["copy_device_ms"]}
    emit(rec)
    if worst > E2E_BAR:
        raise SmokeFailure(f"radiance nstr={nstr}: kernel vs plain path "
                           f"{worst:.3g} > {E2E_BAR}")
    del out_p
    graph_check(cell, path, nstr, call, inputs, out_k, rec, reps, owned,
                eager_reason(path, nstr, kw["dtype"], device))
    return rec


def phase_solve(device, reps, cell, owned=()):
    """solve_rte through the kernels against the plain path at one of
    FLUX_CELLS, timed, then the same solve captured and replayed
    (`graph_check`)."""
    import torch

    from sbdart_tpu_torch.solver.disort import eager_reason, solve_rte

    path, nstr, args, kw = solve_cell(cell, device)
    nbc, _, nlyr = args[0].shape
    planck = bool(kw.get("planck"))
    call, inputs = captured_solve(args, kw)

    def run(method):
        return solve_rte(*args, **dict(kw, eig_method=method))

    out_k = call(inputs)            # the eager warm-up of the captured call
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
    rec = {"phase": "solve", "cell": cell, "nstr": nstr, "planck": planck,
           "band_columns": nbc, "k_terms": NK,
           "layers": nlyr, "dtype": "float32", "rel_err": errs,
           "bar": E2E_BAR, "kernel_path_ms": k_ms, "plain_path_ms": p_ms,
           "kernel_path_bc_per_s": nbc / (k_ms / 1e3),
           "plain_path_bc_per_s": nbc / (p_ms / 1e3),
           "kernel_path_device_busy_ms": busy_ms,
           "kernel_path_device_idle_share": (
               None if busy_ms is None else max(0.0, 1.0 - busy_ms / k_ms)),
           "kernel_path_kernel_device_ms": dev["kernel_device_ms"],
           "kernel_path_glue_device_ms": dev["glue_device_ms"],
           "kernel_path_device_ops": dev["device_ops_per_solve"]}
    emit(rec)
    if worst > E2E_BAR:
        raise SmokeFailure(f"solve nstr={nstr} planck={planck}: kernel vs "
                           f"plain path {worst:.3g} > {E2E_BAR}")
    del out_p
    graph_check(cell, path, nstr, call, inputs, out_k, rec, reps, owned,
                eager_reason(path, nstr, kw["dtype"], device))
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


@contextlib.contextmanager
def pipeline_calls():
    """The chunk solvers run_pipeline makes meanwhile (recording_calls)."""
    from sbdart_tpu_torch import pipeline

    with recording_calls(pipeline) as made:
        yield made


def pipeline_graph_check(cfg, res, made) -> dict:
    """`res`, api.run's result for `cfg` (run_pipeline through its cached
    chunk solver: every chunk replayed where the rule captures it), against
    the same run with capture ruled out, to the bit: the keys a cli line
    adds ("graph", its reason where the rule leaves the route eager,
    "graph_rel_err" per field, the eager run's seconds, and for each chunk
    solver in `made` its calls, replays, node count, capture and
    instantiate seconds and pool bytes)."""
    from sbdart_tpu_torch.api import run
    from sbdart_tpu_torch.dtypes import (
        default_device, default_dtype, parse_dtype)
    from sbdart_tpu_torch.pipeline import user_angles
    from sbdart_tpu_torch.solver.disort import eager_reason, route

    umu, phi = user_angles(cfg)
    path = route(nstr=cfg.nstr, onlyfl=umu is None, brdf=None, umu=umu,
                 phi=phi)
    device = default_device()
    dtype = parse_dtype(cfg.dtype) if cfg.dtype else default_dtype(device)
    reason = eager_reason(path, cfg.nstr, dtype, device)
    t0 = time.perf_counter()
    with eager_only():
        want = run(cfg)
    return {"graph": reason is None, "graph_reason": reason,
            "graph_rel_err": outputs_diff(res, want),
            "eager_seconds": time.perf_counter() - t0,
            "chunk_solvers": [
                {"calls": c.calls, "replays": c.replays,
                 "nodes": c.node_count() if c.graph else None,
                 "capture_s": c.capture_s, "instantiate_s": c.instantiate_s,
                 "pool_bytes": c.pool_bytes} for c in made]}


def graph_gate(rec, what):
    """Raise where a cli line's replayed run differs from its eager run."""
    bad = {k: v for k, v in rec["graph_rel_err"].items() if v != 0.0}
    if bad:
        raise SmokeFailure(f"{what}: replayed run differs from eager {bad}")


def phase_cli():
    """The sbdart CLI on BASELINE config 1, and the surface closure."""
    from sbdart_tpu_torch.api import run
    from sbdart_tpu_torch.outputs import format_iout

    with pipeline_calls() as made:
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
           "botup_over_botdn": ratio, "albcon": cfg.albcon,
           **pipeline_graph_check(cfg, res, made)}
    emit(rec)
    graph_gate(rec, "cli config 1")
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

    with pipeline_calls() as made:
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
           "iout11_head": text.splitlines()[:3],
           **pipeline_graph_check(cfg, res, made)}
    emit(rec)
    graph_gate(rec, "cli config 2")
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

    with pipeline_calls() as made:
        cfg, text, cli_s = run_cli(INPUT_C3.format(wlinf=0.25, wlsup=40.0))
        vals = iout10_values(text, "cli config 3")
        cfg_sw = loads_namelist(INPUT_C3.format(wlinf=0.25, wlsup=2.0))
        t0 = time.perf_counter()
        res_sw = run(cfg_sw)
        sw_s = time.perf_counter() - t0
    text_sw = format_iout(res_sw)
    iout10_values(text_sw, "cli config 3 (solar part)")
    ratio = closure(res_sw)
    rec = {"phase": "cli", "input": "BASELINE config 3",
           "iout10": text.strip(),
           "wavelengths": len(spectral_grid(cfg)), "seconds": cli_s,
           "topup_w_m2": vals[4], "solar_part_iout10": text_sw.strip(),
           "solar_part_seconds": sw_s,
           "solar_part_botup_over_botdn": ratio, "albcon": cfg.albcon,
           **pipeline_graph_check(cfg_sw, res_sw, made)}
    emit(rec)
    graph_gate(rec, "cli config 3")
    if abs(ratio - cfg.albcon) > 1e-5:
        raise SmokeFailure(f"cli config 3: botup/botdn = {ratio} != albcon")
    return rec


def phase_cli_config4(nstr=16):
    """BASELINE config 4 (rural aerosol, nstr=16, radiances at 6 zenith x
    3 azimuth angles, iout=20), or its namelist at another `nstr` (10: the
    generic path, B5 at N = 5), through the CLI in float32 on the kernels:
    the iout=20 text as api.run renders it; the mean TOA radiance above
    the same run's without aerosol (tests/test_pipeline.py:137-156); uu
    finite and, as that test asks, >= -1e-9 on the float64 route (the
    plain versions on the card); the float32 route within 1e-2 of it (of
    its max), config 2's bar: the path integrals' 1 - exp(-x) loses
    float32 digits on layers as thin as 1e-5 (as the reference's float32
    lane path does), and near-zero radiances come out a rounding below
    zero."""
    import numpy as np

    from sbdart_tpu_torch.api import run
    from sbdart_tpu_torch.namelist import loads_namelist
    from sbdart_tpu_torch.outputs import format_iout, integrate_spectral

    with pipeline_calls() as made:
        cfg, text, cli_s = run_cli(INPUT_C4.format(iaer=1, nstr=nstr))
    res = run(cfg)
    if format_iout(res) != text:
        raise SmokeFailure("cli config 4: text differs from api.run's")
    uu = res.uu
    if uu is None or uu.shape != (len(res.wl), res.nlev, 6, 3):
        raise SmokeFailure(f"cli config 4: uu shape "
                           f"{None if uu is None else uu.shape}")
    t0 = time.perf_counter()
    uu64 = run(cfg, dtype="float64").uu
    f64_s = time.perf_counter() - t0
    clean = run(loads_namelist(INPUT_C4.format(iaer=0, nstr=nstr)))

    def toa_mean(r):
        return float(integrate_spectral(r, r.uu)[0].mean())

    scale = float(np.abs(uu64).max())
    rec = {"phase": "cli", "input": "BASELINE config 4",
           "nstr": nstr, "wavelengths": int(len(res.wl)), "seconds": cli_s,
           "iout20_head": text.splitlines()[:4],
           "uu_min": float(uu.min()), "uu_max": float(uu.max()),
           "uu_f64_min": float(uu64.min()),
           "uu_rel_err_vs_f64": float(np.abs(uu - uu64).max()) / scale,
           "bar": OLR_BAR,
           "f64_plain_seconds": f64_s,
           "toa_mean_radiance": toa_mean(res),
           "toa_mean_radiance_no_aerosol": toa_mean(clean),
           **pipeline_graph_check(cfg, res, made)}
    emit(rec)
    graph_gate(rec, f"cli config 4 (nstr={nstr})")
    if not (np.isfinite(uu).all() and np.isfinite(uu64).all()):
        raise SmokeFailure("cli config 4: non-finite radiances")
    if rec["uu_f64_min"] < -1e-9:
        raise SmokeFailure(f"cli config 4: negative radiance "
                           f"{rec['uu_f64_min']} (f64)")
    if rec["uu_rel_err_vs_f64"] > OLR_BAR:
        raise SmokeFailure(f"cli config 4: f32 vs f64 "
                           f"{rec['uu_rel_err_vs_f64']:.3g} > {OLR_BAR}")
    if not rec["toa_mean_radiance"] > rec["toa_mean_radiance_no_aerosol"]:
        raise SmokeFailure("cli config 4: aerosol did not raise the mean "
                           "TOA radiance")
    return rec


def phase_albtrn():
    """ibcnd=1 through the CLI on the card in float32 (B1 and B2): the
    slab albedo and transmission at three incidence angles are finite,
    0 <= albedo, trn <= 1 and albedo + trn <= 1 over the black surface
    (to 1e-5), and the kernel route is within E2E_BAR of the plain route
    on the card."""
    import numpy as np

    from sbdart_tpu_torch.outputs import format_albtrn
    from sbdart_tpu_torch.pipeline import run_albtrn

    cfg, text, cli_s = run_cli(INPUT_ALBTRN)
    res = run_albtrn(cfg)
    if format_albtrn(res) != text:
        raise SmokeFailure("albtrn: text differs from run_albtrn's")
    t0 = time.perf_counter()
    plain = run_albtrn(cfg, eig_method="plain")
    plain_s = time.perf_counter() - t0
    a, t = res.albmed, res.trnmed
    errs = {f: float(np.abs(getattr(res, f) - getattr(plain, f)).max()
                     / np.abs(getattr(plain, f)).max())
            for f in ("albmed", "trnmed")}
    rec = {"phase": "albtrn", "input": "ibcnd=1, nstr=4, uzen 0/45/75",
           "dtype": str(a.dtype), "shape": list(a.shape),
           "seconds": cli_s, "plain_seconds": plain_s,
           "albedo_min": float(a.min()), "albedo_max": float(a.max()),
           "trn_max": float(t.max()), "albedo_plus_trn_max": float(
               (a + t).max()), "rel_err": errs, "bar": E2E_BAR,
           "first_rows": text.splitlines()[:4]}
    emit(rec)
    if a.shape != (len(res.wl), 3) or not (np.isfinite(a).all()
                                           and np.isfinite(t).all()):
        raise SmokeFailure("albtrn: non-finite or misshapen output")
    if a.min() < 0.0 or t.max() > 1 + 1e-5 or (a + t).max() > 1 + 1e-5:
        raise SmokeFailure(f"albtrn: albedo {a.min()}..{a.max()}, trn max "
                           f"{t.max()}, albedo + trn max {(a + t).max()}")
    if max(errs.values()) > E2E_BAR:
        raise SmokeFailure(f"albtrn: kernel vs plain route {errs}")
    return rec


def c5_batch(ncols=None):
    """The config 5 batch: perturbation k of C5_COLUMNS at zenith z of
    C5_ZENITHS is column k * C5_ZENITHS + z; perturbation 0 is the nominal
    column (every scale 1), the others draw gas (0.7-1.3), cloud and
    aerosol burdens (0-2) and albedo (0.5-1.5) scales from numpy seed 5.
    The first `ncols` columns, or all."""
    import numpy as np

    from sbdart_tpu_torch.batch import ColumnBatch

    rng = np.random.default_rng(5)
    scales = {k: rng.uniform(lo, hi, C5_COLUMNS) for k, lo, hi in (
        ("gas_scale", 0.7, 1.3), ("cld_scale", 0.0, 2.0),
        ("aer_scale", 0.0, 2.0), ("albedo_scale", 0.5, 1.5))}
    for v in scales.values():
        v[0] = 1.0
    csza = np.cos(np.deg2rad(np.linspace(0.0, 85.0, C5_ZENITHS)))
    n = C5_COLUMNS * C5_ZENITHS if ncols is None else ncols
    return ColumnBatch(csza=np.tile(csza, C5_COLUMNS)[:n],
                       **{k: np.repeat(v, C5_ZENITHS)[:n]
                          for k, v in scales.items()})


def batch_errs(got, want, cols=slice(None)):
    """max |got - want| / max |want| of each integrated flux (of `got`'s
    columns `cols`)."""
    import numpy as np

    return {f: float(np.abs(getattr(got, f)[cols] - getattr(want, f)).max()
                     / np.abs(getattr(want, f)).max())
            for f in ("fdir", "fdn", "fup")}


def c5_columns(batch, cols):
    """The columns `cols` of a ColumnBatch, as a ColumnBatch."""
    from sbdart_tpu_torch.batch import ColumnBatch

    return ColumnBatch(**{k: getattr(batch, k)[cols] for k in (
        "csza", "gas_scale", "cld_scale", "aer_scale", "albedo_scale")})


def phase_batch(device):
    """BASELINE config 5 at a reduced scale through run_batch on the card
    in float32 (the Planck source on every chunk: B3 and B2), timed, then
    one column chunk's device busy time from a resume that recomputes it
    under the profiler.  Checks: every flux finite; the resume (every other
    chunk from its checkpoint) equal to the first run bit for bit; the
    nominal column within E2E_BAR of run_pipeline's spectrally integrated
    fluxes at its zenith; fdn >= -1e-6 of its max on the float64 plain
    route on the card (the first 64 columns and the float32 run's most
    negative one), the float32 fluxes there within OLR_BAR of it, and the
    float32 fdn >= -E2E_BAR of its max: where fdn is zero (the top level)
    float32 leaves rounding of either sign, as the plain route on the card
    and the CPU do alike."""
    import numpy as np

    from sbdart_tpu_torch.batch import run_batch
    from sbdart_tpu_torch.dtypes import default_dtype
    from sbdart_tpu_torch.namelist import loads_namelist
    from sbdart_tpu_torch.outputs import integrate_spectral
    from sbdart_tpu_torch.pipeline import run_pipeline
    from sbdart_tpu_torch.solar import spectral_grid

    from sbdart_tpu_torch import batch as batch_mod

    cfg = loads_namelist(INPUT_C5.format(wlsup=40.0, nothrm=-1)).validate()
    batch = c5_batch()
    n, nwl = len(batch), len(spectral_grid(cfg))
    kw = dict(band_chunk=C5_BAND_CHUNK, col_chunk=C5_COL_CHUNK, device=device)
    with tempfile.TemporaryDirectory() as ck:
        with recording_calls(batch_mod) as made:
            t0 = time.perf_counter()
            res = run_batch(cfg, batch, checkpoint_dir=ck, **kw)
            wall = time.perf_counter() - t0
        (call,) = made
        graph = {"graph": call.capture, "band_chunk_solves": call.calls,
                 "replays": call.replays, "capture_s": call.capture_s,
                 "instantiate_s": call.instantiate_s,
                 "pool_bytes": call.pool_bytes,
                 "nodes": call.node_count() if call.graph else None}
        del call, made
        lo = (n - 1) // C5_COL_CHUNK * C5_COL_CHUNK
        os.remove(os.path.join(ck, f"cols_{lo}_{n}.npz"))
        out = []
        ev = device_events(lambda: out.append(run_batch(
            cfg, batch, checkpoint_dir=ck, **kw)), 1, warmup=False,
            cpu=False)
        resumed = out[0]
    # the replayed band-chunk solves against the same run eagerly, on the
    # first two column chunks
    two = slice(0, 2 * C5_COL_CHUNK)
    t0 = time.perf_counter()
    with eager_only():
        eager = run_batch(cfg, c5_columns(batch, two), **kw)
    graph.update(eager_seconds_two_chunks=time.perf_counter() - t0,
                 rel_err=outputs_diff(
                     SimpleNamespace(**{f: getattr(res, f)[two] for f in
                                        ("fdir", "fdn", "fup")}), eager))
    z = C5_PIPELINE_COLUMN
    sza = float(np.rad2deg(np.arccos(batch.csza[z])))
    ref = run_pipeline(cfg.replace(sza=sza))
    pipe = {"fdn": (res.fdir[z] + res.fdn[z],
                    integrate_spectral(ref, ref.fdir + ref.fdn)),
            "fup": (res.fup[z], integrate_spectral(ref, ref.fup))}
    pipe_err = {k: float(np.abs(a - b).max() / np.abs(b).max())
                for k, (a, b) in pipe.items()}
    worst = int(np.unravel_index(np.argmin(res.fdn), res.fdn.shape)[0])
    cols = list(range(64)) + [worst]
    t0 = time.perf_counter()
    r64 = run_batch(cfg, c5_columns(batch, cols), band_chunk=512,
                    dtype="float64", eig_method="plain", device=device)
    f64_s = time.perf_counter() - t0
    f32_vs_f64 = batch_errs(res, r64, cols)
    busy = sum(t for _, t in ev) / 1e3 if ev else None
    chunk_wall = wall / -(-n // C5_COL_CHUNK) * 1e3
    per = {k: sum(t for name, t in ev if re.search(spec[4], name)) / 1e3
           for k, spec in KERNELS.items()}
    rec = {"phase": "batch", "input": "BASELINE config 5, reduced",
           "reduced": f"{n} columns ({C5_ZENITHS} zeniths x {C5_COLUMNS} "
                      "perturbed) of 10^5: the script's time limit",
           "columns": n, "wavelengths": nwl, "k_terms": 3,
           "layers": int(res.fdn.shape[1] - 1),
           "dtype": str(default_dtype(device)),
           "col_chunk": C5_COL_CHUNK, "band_chunk": C5_BAND_CHUNK,
           "seconds": wall, "columns_per_s": n / wall,
           "band_columns_per_s": n * nwl / wall,
           "column_chunk_wall_ms": chunk_wall,
           "column_chunk_device_busy_ms": busy,
           "column_chunk_device_idle_share": (
               None if busy is None else max(0.0, 1.0 - busy / chunk_wall)),
           "column_chunk_kernel_device_ms": {k: v for k, v in per.items()
                                             if v},
           "column_chunk_device_ops": len(ev),
           "surface_fdn_mean": float((res.fdir + res.fdn)[:, -1].mean()),
           "pipeline_column_sza": sza, "pipeline_rel_err": pipe_err,
           "bar": E2E_BAR, "fdn_min_over_max": float(
               res.fdn.min() / np.abs(res.fdn).max()),
           "fdn_min_column": worst,
           "f64_fdn_min_over_max": float(r64.fdn.min()
                                         / np.abs(r64.fdn).max()),
           "f32_vs_f64": f32_vs_f64, "f64_bar": OLR_BAR,
           "f64_plain_seconds": f64_s, "captured": graph}
    emit(rec)
    bad = {k: v for k, v in graph["rel_err"].items() if v != 0.0}
    if bad or not graph["graph"] or graph["replays"] < 1:
        raise SmokeFailure(f"batch: replayed column chunks vs eager {bad}, "
                           f"graph {graph['graph']}, {graph['replays']} "
                           "replays")
    fields = (res.fdir, res.fdn, res.fup)
    if not all(np.isfinite(f).all() and f.shape == (n, 33) for f in fields):
        raise SmokeFailure("batch: non-finite or misshapen fluxes")
    if not all(np.array_equal(getattr(resumed, f), getattr(res, f))
               for f in ("fdir", "fdn", "fup")):
        raise SmokeFailure("batch: resume differs from the first run")
    if max(pipe_err.values()) > E2E_BAR:
        raise SmokeFailure(f"batch: nominal column vs run_pipeline {pipe_err}")
    if (rec["f64_fdn_min_over_max"] < -1e-6
            or rec["fdn_min_over_max"] < -E2E_BAR
            or max(f32_vs_f64.values()) > OLR_BAR):
        raise SmokeFailure(f"batch: fdn {rec['fdn_min_over_max']} of max "
                           f"(float64 {rec['f64_fdn_min_over_max']}), float32 "
                           f"vs float64 {f32_vs_f64}")
    return rec


def phase_batch_solar(device):
    """config 5's solar-only sub-batch (0.25-4 um, nothrm=1: B1 and B2),
    its first 64 columns in band chunks of 512, through the kernels within
    E2E_BAR of the plain path on the card."""
    from sbdart_tpu_torch.batch import run_batch
    from sbdart_tpu_torch.namelist import loads_namelist

    cfg = loads_namelist(INPUT_C5.format(wlsup=4.0, nothrm=1)).validate()
    batch = c5_batch(64)
    kw = dict(band_chunk=512, device=device)
    t0 = time.perf_counter()
    res = run_batch(cfg, batch, **kw)
    k_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = run_batch(cfg, batch, eig_method="plain", **kw)
    p_s = time.perf_counter() - t0
    errs = batch_errs(res, plain)
    rec = {"phase": "batch", "input": "config 5 solar-only sub-batch",
           "columns": len(batch), "seconds": k_s, "plain_seconds": p_s,
           "rel_err": errs, "bar": E2E_BAR}
    emit(rec)
    if max(errs.values()) > E2E_BAR:
        raise SmokeFailure(f"batch solar: kernel vs plain path {errs}")
    return rec


def phase_distributed(device):
    """init_distributed on NCCL with a world of one (a file store): the
    first 256 columns of config 5, in two column chunks, through run_batch's
    process-group route (one all-reduce over the band group, one all-gather
    over the data group) with a checkpoint directory, equal to the run
    without a process group to the bit; then three resumes on the grid,
    each after the agreement collective (an all-reduce on NCCL), on a
    "resume" line with their seconds: from every checkpoint (equal, no
    kernel launched), with the first chunk's file poisoned (the poison
    shows, the rest equal) and with that file deleted (that chunk alone
    recomputed, equal again).  Last, with LOCAL_RANK unset,
    sharding._local_rank refuses a process id at the card count."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from sbdart_tpu_torch.batch import run_batch
    from sbdart_tpu_torch.namelist import loads_namelist
    from sbdart_tpu_torch.sharding import (
        _local_rank,
        init_distributed,
        make_mesh,
    )

    cfg = loads_namelist(INPUT_C5.format(wlsup=40.0, nothrm=-1)).validate()
    batch = c5_batch(C5_DIST_COLUMNS)
    kw = dict(band_chunk=C5_BAND_CHUNK, col_chunk=C5_DIST_COL_CHUNK,
              device=device)
    fields = ("fdir", "fdn", "fup")
    single = run_batch(cfg, batch, **kw)

    def equal(res, cols=slice(None)):
        return all(np.array_equal(getattr(res, f)[cols],
                                  getattr(single, f)[cols]) for f in fields)

    def launched():
        now = kernel_launches()
        return (now.get("eig_beam_scatter_n2", 0)
                + now.get("block_thomas_rt_n2", 0))

    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck")
        first = os.path.join(ck, f"cols_0_{C5_DIST_COL_CHUNK}.npz")
        t0 = time.perf_counter()
        init_distributed(f"file://{tmp}/init", 1, 0, backend="nccl")
        try:
            backend = dist.get_backend()
            mesh = make_mesh(1)
            n0 = launched()
            grouped = run_batch(cfg, batch, mesh=mesh, checkpoint_dir=ck,
                                **kw)
            first_launches = launched() - n0
            seconds = time.perf_counter() - t0
            files = sorted(f for f in os.listdir(ck) if f.endswith(".npz"))
            t0 = time.perf_counter()
            n0 = launched()
            resumed = run_batch(cfg, batch, mesh=mesh, checkpoint_dir=ck,
                                **kw)
            resume_launches = launched() - n0
            with np.load(first) as z:
                arrays = {f: z[f] for f in fields}
            np.savez(first, **{**arrays, "fdir": arrays["fdir"] * 0 + 7.0})
            poisoned = run_batch(cfg, batch, mesh=mesh, checkpoint_dir=ck,
                                 **kw)
            os.remove(first)
            n0 = launched()
            recomputed = run_batch(cfg, batch, mesh=mesh, checkpoint_dir=ck,
                                   **kw)
            recompute_launches = launched() - n0
            resume_seconds = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
    first_equal = equal(grouped)
    rec = {"phase": "distributed", "backend": backend, "world_size": 1,
           "mesh": mesh.shape, "columns": len(batch),
           "col_chunk": C5_DIST_COL_CHUNK, "checkpoints": files,
           "seconds": seconds, "equal_to_single_run": first_equal,
           "untested": "two or more cards (one card here: NCCL refuses "
                       "two ranks on one device)"}
    emit(rec)
    if backend != "nccl" or not first_equal:
        raise SmokeFailure(f"distributed: backend {backend}, equal "
                           f"{first_equal}")
    rest = slice(C5_DIST_COL_CHUNK, None)
    resume = {
        "phase": "resume", "backend": backend, "seconds": resume_seconds,
        "from_every_checkpoint_equal": equal(resumed),
        "from_every_checkpoint_launches": resume_launches,
        "poison_shown": bool(np.all(
            poisoned.fdir[:C5_DIST_COL_CHUNK] == 7.0)),
        "poisoned_rest_equal": equal(poisoned, rest),
        "deleted_chunk_recomputed_equal": equal(recomputed),
        "recompute_launches": recompute_launches,
        "first_run_launches": first_launches}
    emit(resume)
    if not (resume["from_every_checkpoint_equal"] and resume_launches == 0
            and resume["poison_shown"] and resume["poisoned_rest_equal"]
            and resume["deleted_chunk_recomputed_equal"]
            and 2 * recompute_launches == first_launches > 0
            and len(files) == 2):
        raise SmokeFailure(f"distributed resume: {resume}, files {files}")
    count = torch.cuda.device_count()
    saved = os.environ.pop("LOCAL_RANK", None)
    try:
        _local_rank(count)
    except ValueError as e:
        refusal = str(e)
    else:
        raise SmokeFailure(f"_local_rank({count}) without LOCAL_RANK on "
                           f"{count} cards did not refuse")
    finally:
        if saved is not None:
            os.environ["LOCAL_RANK"] = saved
    emit({"phase": "local_rank", "process_id": count, "cards": count,
          "refusal": refusal})
    return rec


def phase_planck_total(device):
    """solver/planck.py:planck_total in float64 on the card:
    sigma T^4 / pi over 1e-6-1e4 K (1001 log-spaced temperatures) against
    NumPy's float64 evaluation, relative error <= 1e-12."""
    import numpy as np
    import torch

    from sbdart_tpu_torch.constants import STEFAN_BOLTZMANN
    from sbdart_tpu_torch.solver.planck import planck_total

    t = 10.0 ** np.linspace(-6.0, 4.0, 1001)
    got = planck_total(torch.tensor(t, device=device))
    want = STEFAN_BOLTZMANN / np.pi * t**4
    rel = float(np.max(np.abs(got.cpu().numpy() - want) / want))
    rec = {"phase": "planck_total", "kelvin": [float(t[0]), float(t[-1])],
           "n": len(t), "device": str(got.device), "dtype": str(got.dtype),
           "max_rel_err": rel, "bar": PLANCK_TOTAL_BAR}
    emit(rec)
    if not (got.device.type == "cuda" and got.dtype == torch.float64
            and rel <= PLANCK_TOTAL_BAR):
        raise SmokeFailure(f"planck_total: {rec}")
    return rec


KERNELS = {   # name: (wrapper module, wrapper, source, the TPU kernel,
              #        a regular expression for its CUDA kernels' names:
              #        B4 and B9 share eig_beam_group_kernel<N, G, kBeam>)
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
    "eig_beam": ("eig_beam", "eig_beam_chain", "eig_beam_group.cu",
                 "sbdart_tpu/pallas/eig.py:281",
                 r"eig_beam_group_kernel(<\d+, \d+, true>|ILi\d+ELi\d+ELb1E)"),
    "blocktri_rt": ("blocktri_rt", "block_thomas_rt", "blocktri_rt.cu",
                    "sbdart_tpu/pallas/blocktri.py:269",
                    "blocktri_rt_kernel"),
    "blocktri_rt_fwd": ("blocktri_rt_streamed", "block_thomas_rt_fwd",
                        "blocktri_rt_streamed.cuh",
                        "sbdart_tpu/pallas/blocktri.py:373",
                        "blocktri_rt_fwd_kernel"),
    "radsrc": ("radsrc", "rad_source_lane", "radsrc.cu",
               "sbdart_tpu/pallas/radsrc.py:61", "radsrc_kernel"),
    "eig_n2_planar": ("eig_n2", "eig_beam_chain_n2", "eig_n2_planar.cu",
                      "sbdart_tpu/pallas/eig.py:764",
                      "eig_n2_planar_kernel"),
    "eig_chain": ("eig_chain", "eig_chain", "eig_beam_group.cu",
                  "sbdart_tpu/pallas/eig.py:272",
                  r"eig_chain_kernel|"
                  r"eig_beam_group_kernel(<\d+, \d+, false>|ILi\d+ELi\d+ELb0E)"),
    "block_thomas": ("blocktri", "block_thomas", "block_thomas.cu",
                     "sbdart_tpu/pallas/blocktri.py:93",
                     "block_thomas_kernel"),
    "blocktri_rt_fwd_group": ("blocktri_rt_streamed",
                              "block_thomas_rt_fwd_group",
                              "blocktri_rt_streamed_group.cu",
                              "sbdart_tpu/pallas/blocktri.py:373",
                              "blocktri_rt_fwd_group_kernel"),
    "blocktri_rt_bwd_group": ("blocktri_rt_streamed",
                              "block_thomas_rt_bwd_group",
                              "blocktri_rt_bwd.cu",
                              "sbdart_tpu/pallas/blocktri.py:457",
                              "blocktri_rt_bwd_group_kernel"),
    "blocktri_rt_group": ("blocktri_rt", "block_thomas_rt_group",
                          "blocktri_rt_group.cu",
                          "sbdart_tpu/pallas/blocktri.py:269",
                          "blocktri_rt_group_kernel"),
    "block_thomas_group": ("blocktri", "block_thomas_group",
                           "block_thomas.cu",
                           "sbdart_tpu/pallas/blocktri.py:93",
                           "block_thomas_(group|rows)_kernel"),
    "planck_band": ("planck", "planck_band", "planck_band.cu",
                    "none (port only)", "planck_band_kernel"),
    "thermal_particular_scan": ("thermal", "thermal_particular_scan",
                                "thermal_particular.cu", "none (port only)",
                                "thermal_particular_kernel"),
    "deltam_attenuation": ("deltam_attenuation", "deltam_attenuation",
                           "deltam_attenuation.cu", "none (port only)",
                           "deltam_attenuation_kernel"),
}


def ptxas_of(log, source):
    """ptxas's report (registers, stack, spills) of one source's kernels,
    from the build log (its nvcc command line, then its output)."""
    lines, mine = [], False
    for ln in log.read_text().splitlines():
        if " -c -o " in ln:
            mine = ln.endswith(source)
        elif mine and ("registers" in ln or "spill" in ln
                       or "Compiling entry" in ln):
            lines.append(ln.strip())
    return lines


def sass_summary(lib, match):
    """Static SASS of the kernels in the library `lib` whose (mangled)
    names the regular expression `match` finds, from cuobjdump -sass:
    {name: {"instructions": n, "ops": the twelve commonest opcodes with
    their counts}}, or None without cuobjdump."""
    exe = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                       "cuobjdump")
    if not os.path.exists(exe):
        return None
    out = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300).stdout
    found, cur = {}, None
    for ln in out.splitlines():
        head = re.match(r"\s*Function : (\S+)", ln)
        if head:
            cur = head.group(1) if re.search(match, head.group(1)) else None
            if cur:
                found[cur] = {}
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\w*)",
                       ln)
        if cur and ins:
            found[cur][ins.group(1)] = found[cur].get(ins.group(1), 0) + 1
    return {name: {"instructions": sum(ops.values()),
                   "ops": dict(sorted(ops.items(), key=lambda kv: -kv[1])[:12])}
            for name, ops in found.items()}


@contextlib.contextmanager
def rt_shape_tally():
    """Count B5's eager launches on the main path by shape: {(layers, N,
    columns): calls of block_thomas_rt through solve_bvp outside a CUDA
    graph capture} (a replay calls no wrapper: its launches are in the
    kernels summary, not by shape)."""
    import torch

    from sbdart_tpu_torch.kernels import blocktri_rt_streamed as b6

    tally = {}
    wrapper = b6.block_thomas_rt

    def counted(gp, *rest):
        if not torch.cuda.is_current_stream_capturing():
            key = tuple(int(x)
                        for x in (gp.shape[0], gp.shape[1], gp.shape[-1]))
            tally[key] = tally.get(key, 0) + 1
        return wrapper(gp, *rest)

    b6.block_thomas_rt = counted
    try:
        yield tally
    finally:
        b6.block_thomas_rt = wrapper


def main() -> int:
    import torch

    t_start = time.perf_counter()
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
          "ptxas": ptxas, "sass": sass_summary(path, "radsrc")})

    t0 = time.perf_counter()
    # 10 launches a CUDA graph for the main shapes' kernel times
    summary = phase_kernels(device, reps=10)
    for part in (phase_kernels_general(device, reps=10),
                 phase_kernels_radiance(device, reps=10),
                 phase_kernels_bvp_n2(device, reps=10),
                 phase_kernels_fwd_rule(device, reps=5),
                 phase_kernels_bwd_rule(device, reps=5),
                 phase_kernels_generic(device, reps=10),
                 phase_kernels_group(device, reps=5),
                 phase_kernels_rt_rule(device, reps=10),
                 phase_kernels_bt_rule(device, reps=5),
                 phase_kernels_far(device),
                 phase_kernels_planck(device, reps=10),
                 phase_kernels_thermal(device, reps=10),
                 phase_kernels_deltam(device, reps=10)):
        merge(summary, part)
    t_kernels = time.perf_counter() - t0

    wrappers = {k: f for k, (_, f, _, _, _) in KERNELS.items()}
    def cell(phase, *a, owned, **k):
        """A solve cell's phase, given the kernels its path runs."""
        return (lambda: phase(device, *a, owned=owned, **k)), owned

    owners = [   # each phase of the main path and the kernels it runs
        cell(phase_solve, 10, "nstr4-flux-33L",
             owned=("eig_n2_deltam", "blocktri_rt_n2")),
        cell(phase_solve, 10, "nstr16-flux-65L",
             owned=("eig_beam", "blocktri_rt_fwd_group",
                    "blocktri_rt_bwd_group")),
        cell(phase_solve, 10, "nstr4-thermal-33L",
             owned=("deltam_attenuation", "eig_n2_scatter", "blocktri_rt_n2",
                    "planck_band", "thermal_particular_scan")),
        cell(phase_solve, 10, "nstr4-flux-65L",
             owned=("eig_n2_deltam", rt_kernel(2))),
        cell(phase_radiance, 10, "nstr4-rad-33L",
             owned=("eig_n2_planar", "blocktri_rt_n2", "radsrc")),
        cell(phase_radiance, 10, "nstr16-rad-65L/256",
             owned=("eig_beam", "blocktri_rt_fwd_group",
                    "blocktri_rt_bwd_group", "radsrc")),
        cell(phase_radiance, 5, "nstr16-rad-65L/2048",
             owned=("eig_beam", "blocktri_rt_fwd_group",
                    "blocktri_rt_bwd_group", "radsrc")),
        cell(phase_radiance, 10, "nstr8-brdf-thermal-33L",
             owned=("eig_beam", rt_kernel(4), "radsrc", "planck_band")),
        (phase_cli, ("eig_n2_deltam", "blocktri_rt_n2")),
        (phase_cli_config2, ("deltam_attenuation", "eig_n2_scatter",
                             "blocktri_rt_n2", "planck_band",
                             "thermal_particular_scan")),
        (phase_cli_config3, ("eig_beam", rt_kernel(8), "planck_band",
                             "thermal_particular_scan")),
        (phase_cli_config4, ("eig_beam", rt_kernel(8), "radsrc")),
        cell(phase_generic, 3, "G1",
             owned=("eig_chain", "blocktri_rt_fwd_group",
                    "blocktri_rt_bwd_group")),
        cell(phase_generic, 5, "G2", owned=("eig_chain", rt_kernel(4))),
        cell(phase_generic, 5, "G2-scan", owned=("eig_chain", bt_kernel(8))),
        cell(phase_generic, 5, "G3", owned=("eig_chain", "blocktri_rt_n2")),
        cell(phase_generic, 5, "G4", owned=(rt_kernel(3), "planck_band")),
        cell(phase_generic, 5, "G5", owned=(rt_kernel(5),)),
        cell(phase_generic, 5, "G6", owned=("eig_beam", rt_kernel(4))),
        (lambda: phase_cli_config4(nstr=10), (rt_kernel(5),)),
        cell(phase_generic, 1, "G7", bar=0.0,
             owned=("blocktri_rt_fwd_group", "blocktri_rt_bwd_group")),
        cell(phase_generic, 1, "G8", bar=0.0, owned=("blocktri_rt_group",)),
        cell(phase_generic, 1, "G8-scan", bar=0.0, owned=(bt_kernel(18),)),
        cell(phase_generic, 1, "G9", bar=0.0,
             owned=("blocktri_rt_fwd_group", "blocktri_rt_bwd_group")),
        (lambda: phase_cli_config4(nstr=32),
         ("blocktri_rt_fwd_group", "blocktri_rt_bwd_group")),
        cell(phase_generic, 1, "G10", bar=0.0,
             owned=("blocktri_rt_fwd_group", "blocktri_rt_bwd_group")),
        cell(phase_generic, 1, "G10-scan", bar=0.0,
             owned=("block_thomas_group",)),
        (phase_albtrn, ("eig_n2_deltam", "blocktri_rt_n2")),
        (lambda: phase_batch(device),
         ("deltam_attenuation", "eig_n2_scatter", "blocktri_rt_n2",
          "planck_band", "thermal_particular_scan")),
        (lambda: phase_batch_solar(device),
         ("eig_n2_deltam", "blocktri_rt_n2")),
        (lambda: phase_distributed(device),
         ("deltam_attenuation", "eig_n2_scatter", "blocktri_rt_n2",
          "planck_band", "thermal_particular_scan")),
    ]
    launches = dict.fromkeys(KERNELS, 0)
    walls = []
    with rt_shape_tally() as rt_shapes:
        for phase, owned in owners:
            before = kernel_launches()
            t0 = time.perf_counter()
            rec = phase()
            walls.append(round(time.perf_counter() - t0, 1))
            now = kernel_launches()
            counts = {k: now.get(f, 0) - before.get(f, 0)
                      for k, f in wrappers.items()}
            missed = [k for k in owned if counts[k] == 0]
            if missed:
                raise SmokeFailure(f"{rec['phase']} {rec.get('input', '')} "
                                   f"skipped its kernels {missed}")
            for k, c in counts.items():
                launches[k] += c
    phase_planck_total(device)
    emit({"phase": "rt_shapes", "launches": [
        {"n": n, "layers": nlyr, "columns": b, "kernel": rt_kernel(n),
         "launches": c} for (nlyr, n, b), c in sorted(rt_shapes.items())]})

    emit({"phase": "total", "seconds": time.perf_counter() - t_start,
          "kernel_phase_seconds": t_kernels, "main_path_phase_seconds": walls})
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


def ab_cases(device):
    """(kernel, N, shape, a zero-argument call) for `ab_times`: B9
    on the flat all-mode lanes of G1 (N = 8) and G2 (N = 4), through its
    wrapper, and on the same lanes laid out as layers of 768; B10 through
    block_thomas's route and its group kernel at each m of BT_RULE (the
    parent's route ran one thread per column at every m <= 16); B4
    layered at 65 x 6144 (N = 4, 6, 8) and
    flat at 16 x 65 x 256; B5's designs at rt_operands' shapes and the
    group kernel at G8's (N = 9) and at N = 20 (6 x 6144); B6 forward's
    group kernel at N = 2 (480 x 49152), 8, 10 and 16 (65 x 6144); B6
    backward through its route (the parent's: one thread to N = 8, the
    group kernel past) at each shape of BWD_RULE and at N = 16 x 65 x
    6144;
    B10's group kernel on G7's blocks (m = 20); B2 at 33 x 49152."""
    from sbdart_tpu_torch.kernels import blocktri_rt as b5
    from sbdart_tpu_torch.kernels import blocktri_rt_streamed as b6
    from sbdart_tpu_torch.kernels import eig_beam as b4
    from sbdart_tpu_torch.kernels.blocktri import (
        block_thomas, block_thomas_group)
    from sbdart_tpu_torch.kernels.blocktri_n2 import block_thomas_rt_n2
    from sbdart_tpu_torch.kernels.eig_chain import eig_chain
    from sbdart_tpu_torch.solver.bvp import assemble_blocks

    for name in ("G1", "G2"):
        (cppl, cpml, mu, w), _ = generic_operands(
            name, device)["eig_chain_lane"]
        flat = tuple(x[None].contiguous() for x in (cppl, cpml))
        n, lanes = flat[0].shape[1], flat[0].shape[-1]
        # the same lanes as layers of 768 columns (the layered entry)
        lay = tuple(x.reshape(n, n, lanes // 768, 768).permute(2, 0, 1, 3)
                    .contiguous() for x in (cppl, cpml))
        del cppl, cpml
        yield "eig_chain/flat", n, flat[0].shape, (
            lambda flat=flat, mu=mu, w=w: eig_chain(*flat, mu, w))
        yield "eig_chain/layered", n, lay[0].shape, (
            lambda lay=lay, mu=mu, w=w: eig_chain(*lay, mu, w))
        del flat, lay
    for m in BT_RULE:
        blocks = bt_operands(m, device)
        yield "block_thomas", m, blocks[0].shape, (
            lambda b=blocks: block_thomas(*b))
        yield "block_thomas_group", m, blocks[0].shape, (
            lambda b=blocks: block_thomas_group(*b))
        del blocks

    def b4_call(front):
        return lambda: b4.eig_beam_chain(*front)

    for nstr in (8, 12, 16):
        prob = flux_problem(NBC16, NK, NLYR16, device, nmom=nstr + 1)
        front, bvp = general_kernel_operands(prob, nstr)
        n = nstr // 2
        yield "eig_beam", n, front[0].shape, b4_call(front)
        if n == 8:
            yield "blocktri_rt_fwd_group", 8, bvp[0].shape, (
                lambda bvp=bvp: b6.block_thomas_rt_fwd_group(*bvp))
    ops = radiance_kernel_operands(*radiance_problem(NBC_RAD16, NLYR16, device,
                                                     nstr=16))
    (cppl, cpml, r1, r2, mu0, tab), _ = ops["eig_beam_chain_lane"]
    flat = tuple(x.reshape((1,) + x.shape).contiguous()
                 for x in (cppl, cpml, r1, r2)) + (mu0.contiguous(),
                                                   tab.mu, tab.w)
    yield "eig_beam/flat", 8, flat[0].shape, b4_call(flat)
    one_thread = getattr(b5, "RT_ONE_THREAD_N", range(1, 9))
    for n in RT_RULE_N:
        bvp = tuple(x.contiguous() for x in rt_operands(n, device))
        if n in one_thread:
            yield "blocktri_rt", n, bvp[0].shape, (
                lambda bvp=bvp: b5._launch("blocktri_rt", "sbdart_blocktri_rt",
                                           *bvp))
        yield "blocktri_rt_group", n, bvp[0].shape, (
            lambda bvp=bvp: b5.block_thomas_rt_group(*bvp))
        lanes = getattr(b5, "RT_GROUP_LANES", None)
        if lanes is not None and n in (4, 5, 8):
            for g in sorted({8, 16, 32} - {lanes.get(n, 0)}):
                if g >= 2 * n:
                    yield f"blocktri_rt_group/g{g}", n, bvp[0].shape, (
                        lambda bvp=bvp, n=n, g=g: with_lanes(
                            lanes, n, g, b5.block_thomas_rt_group, bvp))
    for name, nstr, nbc, nlyr in GROUP_SHAPES:
        bvp, _ = generic_kernel_operands(*generic_problem(
            nbc, NK, nlyr, device, nstr=nstr, onlyfl=True))["solve_bvp"]
        bvp = tuple(x.contiguous() for x in bvp)
        n = nstr // 2
        if nlyr == NLYR16:
            yield "blocktri_rt_fwd_group", n, bvp[0].shape, (
                lambda bvp=bvp: b6.block_thomas_rt_fwd_group(*bvp))
            if name == "N16":   # BWD_RULE has G7's shape and G9's
                hist = b6.block_thomas_rt_fwd_plain(*bvp)
                yield "blocktri_rt_bwd/route", n, bvp[0].shape, (
                    lambda bvp=bvp, h=hist: b6.block_thomas_rt_bwd(
                        *bvp[:3], *h))
        else:
            yield "blocktri_rt_group", n, bvp[0].shape, (
                lambda bvp=bvp: b5.block_thomas_rt_group(*bvp))
        if name == "G7":
            blocks = tuple(x.contiguous() for x in
                           (*assemble_blocks(*bvp[:4]), bvp[4]))
            yield "block_thomas_group", 2 * n, blocks[0].shape, (
                lambda b=blocks: block_thomas_group(*b))
    bvp = kernel_operands(flux_problem(NBC, NK, 480, device))[3]
    bvp = tuple(x.contiguous() for x in bvp)
    yield "blocktri_rt_fwd_group", 2, bvp[0].shape, (
        lambda bvp=bvp: b6.block_thomas_rt_fwd_group(*bvp))
    del bvp
    for case in BWD_RULE:
        n = case[0]
        ops = bwd_operands(case, device)
        yield "blocktri_rt_bwd/route", n, ops[0].shape, (
            lambda ops=ops: b6.block_thomas_rt_bwd(*ops))
        del ops
    b2_ops = kernel_operands(flux_problem(NBC, NK, NLYR, device))[3]
    b2_ops = tuple(x.contiguous() for x in b2_ops)
    yield "blocktri_rt_n2", 2, b2_ops[0].shape, (
        lambda ops=b2_ops: block_thomas_rt_n2(*ops))


# B7's --ab shapes: (nstr, layers, band-columns, user cosines, the cell's
# keywords): nstr16-rad-65L at 256 and 2048 columns, at U = 20 at 256, and
# the B7 shapes of nstr4-rad-33L (N = 2) and nstr8-brdf-thermal-33L (N = 4)
RADSRC_AB = [(16, NLYR16, NBC_RAD16, UMU_VIEW, {}),
             (16, NLYR16, NBC16, UMU_VIEW, {}),
             (16, NLYR16, NBC_RAD16, UMU_20, {}),
             (4, NLYR, 4096, UMU_VIEW, {}),
             (8, NLYR, 512, UMU_VIEW, dict(planck=True, brdf=True))]
# the radiance cells that run B7, for --ab's solve lines
def ab_radsrc_cases(device):
    """(kernel, N, shape, call, fields) for `ab_times`: B7 at RADSRC_AB's
    shapes through rad_source_lane, on the path's own operands ("path":
    gp, gm, kk, zp and zm strided views of the eigen output, as radlane
    hands them; a wrapper that copies them pays for it here) and on
    contiguous copies of them ("contiguous": the kernel alone), with the
    bound of the function's bytes."""
    from sbdart_tpu_torch.kernels.radsrc import rad_source_lane

    for nstr, nlyr, nbc, umu, cell in RADSRC_AB:
        src, umu = radsrc_operands(device, nstr, nlyr, nbc, umu, **cell)
        fields = {"umu": len(umu), "layers": nlyr, "band_columns": nbc,
                  **radsrc_bound(src, umu)}
        dense = tuple(x.contiguous() for x in src)
        for kind, ops in (("path", src), ("contiguous", dense)):
            yield f"radsrc/{kind}", nstr // 2, ops[5].shape, (
                lambda ops=ops, umu=umu: rad_source_lane(*ops, umu)), fields
        del src, dense


def ab_solves(device):
    """(cell, solve) for `ab_times`: solve_rte through the kernels at each
    of RADIANCE_CELLS."""
    import torch

    from sbdart_tpu_torch.solver.disort import solve_rte

    for name, cell in RADIANCE_CELLS.items():
        args, kw = radiance_problem(device=device, **cell)
        yield name, (lambda args=args, kw=kw: solve_rte(
            *args, eig_method="auto", dtype=torch.float32, **kw))


def ab_batch(device, repeats=3):
    """For `ab_times` (group "batch"): config 5's 4096 columns through
    run_batch with a checkpoint directory, as the batch phase's first run,
    `repeats` times in one process (the first also loads the kernels and
    warms the caches): each run's wall seconds and columns/s."""
    from sbdart_tpu_torch.batch import run_batch
    from sbdart_tpu_torch.namelist import loads_namelist

    cfg = loads_namelist(INPUT_C5.format(wlsup=40.0, nothrm=-1)).validate()
    batch = c5_batch()
    kw = dict(band_chunk=C5_BAND_CHUNK, col_chunk=C5_COL_CHUNK, device=device)
    walls = []
    for _ in range(repeats):
        with tempfile.TemporaryDirectory() as ck:
            t0 = time.perf_counter()
            run_batch(cfg, batch, checkpoint_dir=ck, **kw)
            walls.append(time.perf_counter() - t0)
    return {"columns": len(batch), "seconds": walls,
            "columns_per_s": [len(batch) / w for w in walls]}


def whole_loop_graph(device):
    """The design the batch did not take: config 5's whole loop over its
    63 band chunks (one column chunk of C5_COL_CHUNK columns) captured as
    one graph, its body the batch's own band-chunk solve run eagerly
    inside it: its node count, capture and instantiate seconds, one
    replay's wall ms, and the replay against the eager loop (rel_err per
    integral, 0.0 to the bit)."""
    import numpy as np
    import torch

    from sbdart_tpu_torch.batch import build_batch_fn
    from sbdart_tpu_torch.namelist import loads_namelist
    from sbdart_tpu_torch.ops.graph import CapturedCall

    cfg = loads_namelist(INPUT_C5.format(wlsup=40.0, nothrm=-1)).validate()
    fn, meta = build_batch_fn(cfg, band_chunk=C5_BAND_CHUNK, device=device)
    cols = c5_columns(c5_batch(), slice(0, C5_COL_CHUNK))
    params = {k: np.asarray(getattr(cols, k)) for k in meta["names"]}
    want = torch.stack(fn(params))
    band = meta["solvers"][C5_COL_CHUNK].fn
    stacked = meta["stacked"]

    def loop(**p):
        acc = torch.zeros_like(want)
        for i in range(next(iter(stacked.values())).shape[0]):
            part = band(**p, **{k: v[i] for k, v in stacked.items()})
            for j in range(3):
                acc[j] += part[j]
        return acc

    tensors = {k: torch.as_tensor(v, dtype=meta["dtype"], device=device)
               for k, v in params.items()}
    call = CapturedCall(loop, capture=True)
    call(tensors)
    got = call(tensors)
    torch.cuda.synchronize()
    err = {f: bit_diff(got[j], want[j])[0]
           for j, f in enumerate(("fdir", "fdn", "fup"))}
    out = {"nodes": call.node_count(), "capture_s": call.capture_s,
           "instantiate_s": call.instantiate_s,
           "pool_bytes": call.pool_bytes,
           "replay_ms": timed_ms(lambda: call(tensors), 2, warmup=0),
           "rel_err": err}
    del call, got
    torch.cuda.empty_cache()
    return out


def ab_graphs(device, repeats=3):
    """For `ab_times` (group "graphs"): run_pipeline through api.run on
    the cli configs 1, 3's solar part, 4 and 4 at nstr=10, `repeats` times
    each in one process (the first also captures where the rule admits
    it), then config 5's batch (`ab_batch`): each run's wall seconds; in a
    checkout that captures, also `whole_loop_graph`."""
    from sbdart_tpu_torch.api import run
    from sbdart_tpu_torch.namelist import loads_namelist

    out = {}
    for name, text in (
            ("config1", INPUT_C1),
            ("config3_solar", INPUT_C3.format(wlinf=0.25, wlsup=2.0)),
            ("config4", INPUT_C4.format(iaer=1, nstr=16)),
            ("config4_nstr10", INPUT_C4.format(iaer=1, nstr=10))):
        cfg = loads_namelist(text)
        walls = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            run(cfg)
            walls.append(time.perf_counter() - t0)
        out[name] = walls
    out["batch"] = ab_batch(device)
    try:
        from sbdart_tpu_torch.ops import graph  # noqa: F401
    except ImportError:     # a checkout from before captured solves
        return out
    return {**out, "whole_loop_graph": whole_loop_graph(device)}


def ab_sweep(device, keys=8):
    """For `ab_times` (group "sweep", asked for by name only): config 4's
    namelist at nstr=32 through api.run once for each of `keys` azimuth
    sets (the last azimuth 180, 179, ...: a new chunk-solver key each) in
    one process.  After each run: the device memory reserved and its peak
    so far (bytes), and where the checkout caches captured solvers
    (`pipeline._captured_solver.entries`), the keys held, their pools'
    bytes and the pool of this run's graph; each run's wall seconds."""
    import torch

    from sbdart_tpu_torch import pipeline
    from sbdart_tpu_torch.api import run
    from sbdart_tpu_torch.namelist import loads_namelist

    entries = getattr(getattr(pipeline, "_captured_solver", None),
                      "entries", None)
    torch.cuda.reset_peak_memory_stats(device)
    rows = []
    for i in range(keys):
        text = INPUT_C4.format(iaer=1, nstr=32).replace(
            "phi=0,90,180", f"phi=0,90,{180 - i}")
        t0 = time.perf_counter()
        run(loads_namelist(text))
        row = {"seconds": time.perf_counter() - t0,
               "reserved": torch.cuda.memory_reserved(device),
               "max_reserved": torch.cuda.max_memory_reserved(device)}
        if entries is not None:
            held = [c for c in entries() if c.graph is not None]
            row.update(keys_held=len(held),
                       pools_held=sum(c.pool_bytes for c in held),
                       this_pool=entries()[-1].pool_bytes)
        rows.append(row)
    out = {"runs": rows,
           "max_reserved": torch.cuda.max_memory_reserved(device),
           "total_memory": torch.cuda.get_device_properties(
               device).total_memory}
    if entries is not None:
        from sbdart_tpu_torch.ops.graph import pool_budget

        out["pool_budget"] = pool_budget(device)
    return out


def ab_times(tree, groups=("radsrc", "solves", "kernels")) -> int:
    """The `--ab` mode: from the sbdart_tpu_torch package of the checkout
    at `tree` (built there), time the kernels of `ab_radsrc_cases`
    (group "radsrc": also the copies the wrapper call launches, from
    torch.profiler) and of `ab_cases` (group "kernels"), one JSON line
    each (device ms per launch, a CUDA graph of 10 launches, median of 5
    replays), and break the radiance solves of `ab_solves` (group
    "solves") into device busy ms, kernels, copies and operations; group
    "batch", asked for by name only, times config 5's batch
    (`ab_batch`), group "graphs", likewise, the cli configs' pipelines
    and the batch (`ab_graphs`: captured where the checkout captures), and
    group "sweep", likewise, device memory over a sweep of chunk-solver
    keys (`ab_sweep`).  Run on two checkouts in turns (parent, change, change,
    parent) within one call to compare them on one card."""
    import torch

    sys.path.insert(0, os.path.abspath(tree))
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    import sbdart_tpu_torch

    from sbdart_tpu_torch.kernels import _build

    path, build_s = _build.build()
    log = path.parent / "build.log"
    emit({"phase": "ab", "tree": os.path.abspath(tree),
          "package": os.path.dirname(sbdart_tpu_torch.__file__),
          "build_seconds": build_s, "device": torch.cuda.get_device_name(0),
          "ptxas_radsrc": ptxas_of(log, "radsrc.cu"),
          "sass": sass_summary(path, "radsrc")})
    cases = []
    if "radsrc" in groups:
        cases.append(ab_radsrc_cases(device))
    if "kernels" in groups:
        cases.append(ab_cases(device))
    for kname, n, shape, call, *fields in (c for g in cases for c in g):
        call()
        torch.cuda.synchronize()
        row = {"phase": "ab", "kernel": kname, "n": n, "shape": list(shape),
               "ms": graph_ms(call, 10), **(fields[0] if fields else {})}
        if kname.startswith("radsrc"):
            dev = device_breakdown(call, 5)
            row.update(copy_ops=dev["copy_ops_per_solve"],
                       copy_device_ms=dev["copy_device_ms"])
        emit(row)
        del call
        torch.cuda.empty_cache()
    if "batch" in groups:
        emit({"phase": "ab", "batch": "config 5", **ab_batch(device)})
    if "graphs" in groups:
        emit({"phase": "ab", "graphs": "pipeline and batch walls",
              **ab_graphs(device)})
    if "sweep" in groups:
        emit({"phase": "ab", "sweep": "config 4 at nstr=32, a key a run",
              **ab_sweep(device)})
    if "solves" in groups:
        for name, solve in ab_solves(device):
            solve()
            emit({"phase": "ab", "solve": name,
                  **device_breakdown(solve, 3)})
            del solve
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    try:
        if len(sys.argv) in (3, 4) and sys.argv[1] == "--ab":
            sys.exit(ab_times(sys.argv[2], *(
                (sys.argv[3].split(","),) if len(sys.argv) == 4 else ())))
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
