"""Pod-scale batch runner: many columns x solar angles x the full spectrum
(torch port of sbdart_tpu/batch.py).

What reference users do with shell loops over INPUT files (SURVEY.md
section 3), and BASELINE.json config 5 ("full 0.25-40 um sweep x 32 solar
zeniths x 10^5 perturbed columns, sharded over N hosts").

Design, as the reference's:
  * the nominal column's optical deck is built ONCE on the host and its
    band tables go to the device once, stacked in band chunks;
  * per-column physics perturbations are SCALINGS applied on the device --
    exact for the linear-in-amount parts (gas k-terms scale linearly in
    absorber amount; cloud/aerosol optical depths linearly in burden);
  * the spectral loop runs over the band chunks (the reference's
    `lax.scan`), each chunk one batched solve_rte over [columns, bands,
    k-terms] adding to three accumulators; as the reference jits that
    loop, its body, one band chunk's solve, is one ops/graph.py:
    CapturedCall per column-chunk shape where solver/disort.py:graph_ok admits
    the route (float32 on the card): the first band chunk runs eagerly
    (the warm-up), every later one has its band tables and columns copied
    into the graph's static inputs and is replayed.  (One graph of the
    whole loop, ~107k nodes at config 5's 63 band chunks, took 1.4 s to
    instantiate on the H100, as long as a column chunk runs; one band
    chunk's ~1.7k nodes take milliseconds, and the first column chunk
    replays too.)  The collectives and the checkpoint decision stay
    outside the graph;
  * on a process grid (sharding.make_mesh) the columns of each column
    chunk are padded to a multiple of `data` and split over the data
    ranks, the band chunks over the band ranks; the band-partial
    integrals are summed by one all-reduce over the band group (the
    reference's `psum`, the only reduction of the physics), then gathered
    over the data group so every rank holds the whole [C, nlev] result;
  * the host loop processes the global column set in column chunks,
    every rank checkpointing each finished chunk to its own
    `<ckpt>/cols_<lo>_<hi>.npz` (every rank holds the same gathered
    result) and skipping chunks already present on restart (jobs are
    re-runnable and idempotent per shard).  On a process grid the skip is
    the world's decision: a chunk is restored only where every rank holds
    its file, so ranks with disks of their own that disagree recompute it
    together and the grid's collectives stay paired chunk for chunk;
  * while recording (tracing.py) a call is one `batch.job` span holding
    the deck build (`pipeline.deck`) and each column chunk's restore
    check, parameter copy, band-chunk solves, collectives, wait for the
    results and checkpoint write (`batch.restore_check`, `batch.params`,
    `batch.bands`, `batch.collectives`, `batch.collect`,
    `batch.checkpoint`); a restored chunk adds to the counter
    `batch.restored_chunks`.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from sbdart_tpu_torch import tracing
from sbdart_tpu_torch.aerosols import aerosol_optical_properties
from sbdart_tpu_torch.atmosphere import build_profile
from sbdart_tpu_torch.clouds import (
    apply_cloud_humidity,
    cloud_mie_moments,
    cloud_optical_properties,
)
from sbdart_tpu_torch.config import Config
from sbdart_tpu_torch.dtypes import default_dtype, parse_dtype
from sbdart_tpu_torch.ops.graph import CapturedCall
from sbdart_tpu_torch.optics import build_optical_deck, component_moments
from sbdart_tpu_torch.pipeline import (
    _trapz_weights,
    band_edges_wavenumber,
    thermal_mask,
)
from sbdart_tpu_torch.rayleigh import rayleigh_moments
from sbdart_tpu_torch.sharding import make_mesh, pad_to_multiple, rank_device
from sbdart_tpu_torch.solar import filter_function, solar_irradiance, spectral_grid
from sbdart_tpu_torch.solver.disort import graph_ok, route, solve_rte
from sbdart_tpu_torch.surface import surface_albedo

log = logging.getLogger("sbdart_tpu_torch.batch")

PARAM_NAMES = ("albedo_scale", "aer_scale", "cld_scale", "csza", "gas_scale")


@dataclasses.dataclass
class ColumnBatch:
    """Per-column perturbation parameters (all shape [C])."""
    csza: np.ndarray
    gas_scale: np.ndarray | None = None
    h2o_scale: np.ndarray | None = None   # alias of gas_scale for clarity
    cld_scale: np.ndarray | None = None
    aer_scale: np.ndarray | None = None
    albedo_scale: np.ndarray | None = None

    def __post_init__(self):
        c = len(self.csza)
        ones = np.ones(c)
        if self.gas_scale is None:
            self.gas_scale = (
                self.h2o_scale if self.h2o_scale is not None else ones
            )
        if self.cld_scale is None:
            self.cld_scale = ones
        if self.aer_scale is None:
            self.aer_scale = ones
        if self.albedo_scale is None:
            self.albedo_scale = ones

    def __len__(self) -> int:
        return len(self.csza)

    def slice(self, lo: int, hi: int) -> "ColumnBatch":
        return ColumnBatch(
            csza=self.csza[lo:hi],
            gas_scale=self.gas_scale[lo:hi],
            cld_scale=self.cld_scale[lo:hi],
            aer_scale=self.aer_scale[lo:hi],
            albedo_scale=self.albedo_scale[lo:hi],
        )


@dataclasses.dataclass
class BatchResult:
    """Spectrally integrated fluxes per column [C, nlev]."""
    fdir: np.ndarray
    fdn: np.ndarray
    fup: np.ndarray
    csza: np.ndarray
    z: np.ndarray


def _stack_chunks(arrs: dict, nchunk: int, chunk: int) -> dict:
    """[nwl, ...] -> [nchunk, chunk, ...] with edge padding.

    Padded entries replicate the last band EXCEPT the integration weight
    `w_int`, which is zeroed so padding never contributes to integrals.
    """
    out = {}
    for k, a in arrs.items():
        n = a.shape[0]
        pad = nchunk * chunk - n
        if pad:
            tail = np.repeat(a[-1:], pad, axis=0)
            if k == "w_int":
                tail = np.zeros_like(tail)
            a = np.concatenate([a, tail], axis=0)
        out[k] = a.reshape((nchunk, chunk) + a.shape[1:])
    return out


def build_batch_fn(cfg: Config, *, band_chunk: int = 32, dtype=None,
                   mesh=None, profile=None, eig_method: str = "auto",
                   device=None):
    """Build (fn, static_data) for the batched spectral solve.

    fn(params) -> (fdir, fdn, fup) each [C, nlev] on the device,
    spectrally integrated with the filter weighting; `params` is a dict of
    [C] arrays, C a multiple of the grid's `data`, the same on every rank
    (keyword arguments label fn's spans, sbdart_tpu_torch/tracing.py).
    `eig_method` as in solve_rte; `device` defaults to this rank's
    (sharding.rank_device)."""
    mesh = make_mesh(1) if mesh is None else mesh
    device = rank_device() if device is None else torch.device(device)
    dtype = default_dtype(device) if dtype is None else parse_dtype(dtype)
    # the host set-up, from the profile to the band tables on the card
    with tracing.span("pipeline.deck"):
        if profile is None:
            profile = build_profile(cfg)
        profile = apply_cloud_humidity(profile, cfg)
        wl = spectral_grid(cfg)
        nmom = cfg.nstr + 1
        deck = build_optical_deck(profile, cfg, wl, nmom)

        e0 = solar_irradiance(wl, cfg.nf)
        filt = filter_function(cfg, wl)
        alb = surface_albedo(cfg, wl)
        w_int = filt * _trapz_weights(wl)

        thermal = thermal_mask(cfg, wl)
        any_thermal = bool(thermal.any())
        wvnlo, wvnhi = band_edges_wavenumber(wl)
        band_dlam = 1.0e4 / wvnlo - 1.0e4 / wvnhi

        # scattering components for the per-column recombination
        # ([nwl, nlyr, nmom]); cloud & aerosol moments need (w0, g)
        mom_r = deck.tau_ray[..., None] * rayleigh_moments(nmom)
        tau_c, w0_c, g_c = cloud_optical_properties(profile, cfg, wl)
        tau_a, w0_a, g_a = aerosol_optical_properties(profile, cfg, wl)
        pmaer = np.asarray([p for p in cfg.pmaer], np.float64)
        if cfg.imomc == 4:
            mom_c = (w0_c * tau_c)[..., None] * cloud_mie_moments(
                profile, cfg, wl, nmom
            )
        else:
            mom_c = (w0_c * tau_c)[..., None] * component_moments(
                g_c, cfg.imomc, nmom
            )
        mom_a = (w0_a * tau_a)[..., None] * component_moments(
            g_a, cfg.imoma, nmom,
            user_moments=pmaer if pmaer.size else None)

        nwl = len(wl)
        nchunk = -(-nwl // band_chunk)
        nband = mesh.shape["band"]
        if nchunk % nband:
            # the reference's shard_map refuses uneven band shards likewise
            raise ValueError(f"{nchunk} band chunks not divisible by band "
                             f"axis {nband}")
        per_rank = nchunk // nband
        mine = slice(mesh.band_index * per_rank,
                     (mesh.band_index + 1) * per_rank)
        stacked = _stack_chunks(
            dict(
                tau_ray=deck.tau_ray, tau_gas=deck.tau_gas, wk=deck.wk,
                tau_c=tau_c, scat_c=w0_c * tau_c, mom_c=mom_c,
                tau_a=tau_a, scat_a=w0_a * tau_a, mom_a=mom_a,
                mom_r=mom_r, alb=alb,
                fbeam=e0 * cfg.solfac, w_int=w_int,
                tmask=thermal.astype(np.float64),
                wvnlo=wvnlo, wvnhi=wvnhi, band_dlam=band_dlam,
            ),
            nchunk, band_chunk,
        )
        # this rank's band chunks go to the device once
        stacked = {k: torch.as_tensor(v[mine], dtype=dtype, device=device)
                   for k, v in stacked.items()}

        temper = torch.as_tensor(profile.t, dtype=dtype, device=device)
        btemp = torch.as_tensor(
            cfg.btemp if cfg.btemp > 0 else float(profile.t[-1]),
            dtype=dtype, device=device)
    nlev = profile.nlev

    def band_solve(albedo_scale, aer_scale, cld_scale, csza, gas_scale,
                   **ch):
        """One band chunk's solve over [C_local] parameter tensors and the
        chunk's band tables `ch`: its three spectral integrals, each
        [C_local, nlev]."""
        csza = csza[:, None, None]                         # [C,1,1]
        gs = gas_scale[:, None, None, None]
        cs = cld_scale[:, None, None]
        as_ = aer_scale[:, None, None]
        albs = albedo_scale[:, None, None]
        ncol = csza.shape[0]
        # recombine optical properties [C, B, k, L]
        tau_ray = ch["tau_ray"][None, :, None, :]
        tau_gas = gs * ch["tau_gas"][None]
        tau_cld = cs[..., None] * ch["tau_c"][None, :, None, :]
        tau_aer = as_[..., None] * ch["tau_a"][None, :, None, :]
        dtau = tau_ray + tau_gas + tau_cld + tau_aer
        scat = (
            tau_ray
            + cs[..., None] * ch["scat_c"][None, :, None, :]
            + as_[..., None] * ch["scat_a"][None, :, None, :]
        )
        ssalb = torch.clip(scat / torch.clamp_min(dtau, 1e-30), 0.0, 1.0)
        mom = (
            ch["mom_r"][None, :, None]
            + cs[..., None, None] * ch["mom_c"][None, :, None]
            + as_[..., None, None] * ch["mom_a"][None, :, None]
        )
        pmom = mom / torch.clamp_min(scat[..., None], 1e-30)
        pmom[..., 0].fill_(1.0)

        thermal_c = ch["tmask"][None, :, None] > 0     # [1,B,1]
        fbeam = ch["fbeam"][None, :, None] * torch.where(
            thermal_c, ch["band_dlam"][None, :, None], 1.0
        )
        temper_c = torch.where(thermal_c[..., None], temper, 1e-4)
        out = solve_rte(
            dtau, ssalb, pmom,
            nstr=cfg.nstr,
            fbeam=fbeam, umu0=csza, fisot=cfg.fisot,
            # perturbation scalings must not push albedo past 1
            albedo=torch.clip(albs * ch["alb"][None, :, None], 0.0, 1.0),
            planck=any_thermal,
            temper=temper_c,
            wvnlo=ch["wvnlo"][None, :, None],
            wvnhi=ch["wvnhi"][None, :, None],
            btemp=torch.where(thermal_c, btemp, 1e-4),
            deltam=cfg.deltam, onlyfl=True, dtype=dtype,
            eig_method=eig_method, device=device,
        )
        conv = torch.where(thermal_c, 1.0 / ch["band_dlam"][None, :, None],
                           1.0)
        w = (ch["w_int"][None, :, None] * conv * ch["wk"][None]).expand(
            ncol, -1, -1)
        return tuple(torch.einsum("cbk,cbkv->cv", w, f)
                     for f in (out.rfldir, out.rfldn, out.flup))

    capture = graph_ok(route(nstr=cfg.nstr, onlyfl=True, brdf=None),
                       cfg.nstr, dtype, device)
    solvers = {}        # one CapturedCall per local column count

    def column_solve(solver, params):
        """One rank's spectral loop: the band chunks' integrals summed in
        three accumulators [3, C_local, nlev] (a replay's integrals are
        added before the next replay)."""
        acc = torch.zeros((3, params["csza"].shape[0], nlev), dtype=dtype,
                          device=device)
        for i in range(per_rank):
            part = solver({**params, **{k: v[i] for k, v in stacked.items()}})
            for j in range(3):
                acc[j] += part[j]
        return acc

    def prepare_and_run(params_np: dict, **attrs) -> tuple:
        """fn: this rank's columns to the device, its band chunks solved,
        the grid's collectives; `attrs` label the spans of the three."""
        c = len(params_np["csza"])
        nd = mesh.shape["data"]
        if c % nd:
            raise ValueError(f"{c} columns not divisible by data axis {nd}")
        with tracing.span("batch.params", **attrs):
            lo = mesh.data_index * (c // nd)
            params = {k: torch.as_tensor(
                np.asarray(params_np[k])[lo:lo + c // nd], dtype=dtype,
                device=device) for k in PARAM_NAMES}
        solver = solvers.get(c // nd)
        if solver is None:
            solver = solvers[c // nd] = CapturedCall(band_solve,
                                                     capture=capture)
        with tracing.span("batch.bands", **attrs):
            acc = column_solve(solver, params)
        if mesh.distributed:
            with tracing.span("batch.collectives", **attrs):
                # the only reduction: band-partial integrals summed over
                # 'band'
                dist.all_reduce(acc, group=mesh.band_group)
                parts = [torch.empty_like(acc) for _ in range(nd)]
                dist.all_gather(parts, acc, group=mesh.data_group)
                acc = torch.cat(parts, dim=1)
        return acc[0], acc[1], acc[2]

    return prepare_and_run, dict(
        profile=profile, wl=wl, mesh=mesh, stacked=stacked,
        names=list(PARAM_NAMES), nlev=nlev, device=device, dtype=dtype,
        solvers=solvers,
    )


def _write_run_metadata(checkpoint_dir: str, cfg: Config, meta: dict,
                        n_cols: int, col_chunk: int) -> None:
    """Run-provenance record next to the checkpoints (aux subsystem 6.5)."""
    device = meta["device"]
    payload = {
        "started_unix": time.time(),
        "config": dataclasses.asdict(cfg),
        "n_columns": int(n_cols),
        "col_chunk": int(col_chunk),
        "n_wavelengths": int(len(meta["wl"])),
        "nlev": int(meta["profile"].nlev),
        "mesh": {k: int(v) for k, v in meta["mesh"].shape.items()},
        "backend": dist.get_backend() if dist.is_initialized() else None,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
        "world_size": dist.get_world_size() if dist.is_initialized() else 1,
        "dtype": str(meta["dtype"]),
        "torch_version": torch.__version__,
    }
    os.makedirs(checkpoint_dir, exist_ok=True)
    with open(os.path.join(checkpoint_dir, "run_metadata.json"), "w") as fh:
        json.dump(payload, fh, indent=1, default=str)


def _restore(ck_path: str, mesh, device) -> bool:
    """Whether to restore a column chunk from its checkpoint.  Without a
    process group: whether the file exists.  On a process grid a chunk
    that is recomputed runs the grid's collectives, so every rank must
    take the same branch: one all-reduce (MIN) of each rank's 0/1 over
    the world says whether every rank holds the file."""
    have = os.path.exists(ck_path)
    if not mesh.distributed:
        return have
    flag = torch.tensor([int(have)], dtype=torch.int32, device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


def _save_checkpoint(ck_path: str, **arrays) -> None:
    """Write `ck_path` through a rank-unique temporary name in the same
    directory, then `os.replace` it into place: ranks that share a disk
    write the same path, and a reader never sees a half-written file."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    tmp = f"{ck_path}.{rank}.{os.getpid()}.tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, ck_path)


def run_batch(
    cfg: Config,
    batch: ColumnBatch,
    *,
    mesh=None,
    band_chunk: int = 32,
    col_chunk: int = 1024,
    checkpoint_dir: str | None = None,
    dtype=None,
    eig_method: str = "auto",
    device=None,
) -> BatchResult:
    """Run the full spectral sweep for a batch of perturbed columns.

    On a process grid every rank calls this with the same arguments and
    gets the whole result.  Every rank writes each chunk's checkpoint to
    its `checkpoint_dir` (which may be one shared directory or one on each
    host) and restores a chunk only where every rank holds its file;
    rank 0 writes run_metadata.json."""
    mesh = make_mesh(1) if mesh is None else mesh
    with tracing.span("batch.job", columns=len(batch), col_chunk=col_chunk,
                      band_chunk=band_chunk):
        ndata = mesh.shape["data"]
        fn, meta = build_batch_fn(
            cfg, band_chunk=band_chunk, dtype=dtype, mesh=mesh,
            eig_method=eig_method, device=device,
        )
        profile = meta["profile"]
        n = len(batch)
        nlev = profile.nlev
        fdir = np.zeros((n, nlev))
        fdn = np.zeros((n, nlev))
        fup = np.zeros((n, nlev))

        rank0 = not dist.is_initialized() or dist.get_rank() == 0
        if checkpoint_dir and rank0:
            _write_run_metadata(checkpoint_dir, cfg, meta, n, col_chunk)
        nchunks = -(-n // col_chunk)
        done = solved = 0
        t_start = time.perf_counter()

        for lo in range(0, n, col_chunk):
            hi = min(lo + col_chunk, n)
            ck_path = (
                os.path.join(checkpoint_dir, f"cols_{lo}_{hi}.npz")
                if checkpoint_dir else None
            )
            if ck_path:
                with tracing.span("batch.restore_check", lo=lo, hi=hi):
                    restore = _restore(ck_path, mesh, meta["device"])
                if restore:
                    with np.load(ck_path) as z:  # resume: skip finished shards
                        fdir[lo:hi], fdn[lo:hi], fup[lo:hi] = (
                            z["fdir"], z["fdn"], z["fup"])
                    done += 1
                    tracing.count("batch.restored_chunks")
                    log.info("chunk %d/%d cols %d-%d: restored from "
                             "checkpoint", done, nchunks, lo, hi)
                    continue
            sl = batch.slice(lo, hi)
            params = dict(
                csza=sl.csza, gas_scale=sl.gas_scale, cld_scale=sl.cld_scale,
                aer_scale=sl.aer_scale, albedo_scale=sl.albedo_scale,
            )
            # pad the column axis to the data-grid multiple
            npad = {k: pad_to_multiple(np.asarray(v), ndata)[0]
                    for k, v in params.items()}
            a_dir, a_dn, a_up = fn(npad, lo=lo, hi=hi)
            m = hi - lo
            with tracing.span("batch.collect", lo=lo, hi=hi):
                fdir[lo:hi] = a_dir[:m].cpu().numpy()
                fdn[lo:hi] = a_dn[:m].cpu().numpy()
                fup[lo:hi] = a_up[:m].cpu().numpy()
            if ck_path:
                with tracing.span("batch.checkpoint", lo=lo, hi=hi):
                    os.makedirs(checkpoint_dir, exist_ok=True)
                    _save_checkpoint(ck_path, fdir=fdir[lo:hi], fdn=fdn[lo:hi],
                                     fup=fup[lo:hi])
            done += 1
            solved += m
            # the columns this call solved: restored ones are not counted
            rate = solved / max(time.perf_counter() - t_start, 1e-9)
            log.info("chunk %d/%d cols %d-%d done (%.1f cols/s)",
                     done, nchunks, lo, hi, rate)

        return BatchResult(fdir, fdn, fup, batch.csza, profile.z)
