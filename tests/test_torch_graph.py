"""Captured solves on the CPU (sbdart_tpu_torch/ops/graph.py): what capture
needs, shown without a card.

  * A capture rehearsal for every route solver/disort.py:graph_ok admits on
    the card: after one warm-up call, the float32 solve body runs again
    with every host/device transfer torch offers patched to raise
    (torch.as_tensor, torch.tensor, Tensor.item, .tolist, .cpu, .numpy,
    __bool__, __float__, __int__, indexing with NumPy arrays or lists, and
    item assignment of a Python number), and gives the warm-up's outputs
    to the bit.  The cells are
    chip_smoke.py's solve cells at small widths: the flux lane at nstr 4,
    8 and 16 with and without Planck, the radiance lane at nstr 4 and 16
    and on a Hapke surface with Planck, and the generic cells G1-G9 (G2
    and G8 also by bvp_method "scan").  The same for the pipeline's chunk
    solve and the batch's band-chunk solve.  With the constant cache emptied
    the rehearsal refuses the same body, so it sees the transfers.
  * `_captured_solver` takes the reference's `_jitted_solver` arguments
    in its order, then the static angles, shapes and device; its key does
    not move with the data.
  * The `graph_ok` rule, row by row.
  * The constant cache keeps every tensor it made; graph_cache drops the
    least recently used captured graphs before a capture until their pools
    fit `pool_budget`, keeps to its `maxsize` and counts as lru_cache does
    (stand-in calls: the CPU captures nothing).
  * run_pipeline (several chunks, radiances, a cached solver reused by a
    second run) and run_batch (two column chunks of two shapes) on the
    CPU against the JAX package, float64, as tests/test_torch_pipeline.py
    and tests/test_torch_batch.py hold them (bar 1e-9 of each field's
    max).
"""

import inspect

import numpy as np
import pytest
import torch

from sbdart_tpu import pipeline as ref_pipeline
from sbdart_tpu.batch import ColumnBatch as RefColumnBatch
from sbdart_tpu.batch import run_batch as ref_run_batch
from sbdart_tpu.config import Config as RefConfig
from sbdart_tpu.sharding import make_mesh as ref_make_mesh
from sbdart_tpu_torch import pipeline
from sbdart_tpu_torch.batch import ColumnBatch, build_batch_fn, run_batch
from sbdart_tpu_torch.config import Config
from sbdart_tpu_torch.convert import brdf_to_torch
from sbdart_tpu_torch.ops import graph
from sbdart_tpu_torch.solver.disort import (
    eager_reason,
    graph_ok,
    route,
    solve_rte,
)
from test_torch_generic import generic_problem

CUDA = torch.device("cuda")
F32, F64 = torch.float32, torch.float64


class HostTransfer(RuntimeError):
    pass


def _host_index(key) -> bool:
    keys = key if isinstance(key, tuple) else (key,)
    return any(isinstance(k, (np.ndarray, list)) for k in keys)


def refuse_host_transfers(mp):
    """Patch (through pytest's monkeypatch `mp`) every way torch moves
    data between host and device to raise HostTransfer."""
    def refuse(name):
        def call(*a, **k):
            raise HostTransfer(name)
        return call

    mp.setattr(torch, "as_tensor", refuse("torch.as_tensor"))
    mp.setattr(torch, "tensor", refuse("torch.tensor"))
    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__float__",
                 "__int__"):
        mp.setattr(torch.Tensor, name, refuse(f"Tensor.{name}"))
    get, put = torch.Tensor.__getitem__, torch.Tensor.__setitem__

    def getitem(self, key):
        if _host_index(key):
            raise HostTransfer("indexing with a host array")
        return get(self, key)

    def setitem(self, key, value):
        if _host_index(key):
            raise HostTransfer("indexing with a host array")
        if isinstance(value, (bool, int, float)):
            # a CUDA tensor's item assignment from a Python number copies
            # it from a CPU tensor
            raise HostTransfer("item assignment of a host number")
        return put(self, key, value)

    mp.setattr(torch.Tensor, "__getitem__", getitem)
    mp.setattr(torch.Tensor, "__setitem__", setitem)


def _as_inputs(args, kw, dtype):
    """generic_problem's numpy inputs as the tensors a captured call
    holds (the host angles and Python numbers stay as they are)."""
    def t(x):
        return torch.as_tensor(x, dtype=dtype) if isinstance(
            x, np.ndarray) else x

    kw = {k: v if k in ("umu", "phi") else t(v) for k, v in kw.items()}
    if "brdf" in kw:
        kw["brdf"] = brdf_to_torch(kw["brdf"], device="cpu", dtype=dtype)
    return tuple(t(a) for a in args), kw


CELLS = {   # name: (generic_problem's arguments, solve_rte's extra ones)
    "flux_nstr4": (dict(nstr=4), {}),
    "flux_nstr4_planck": (dict(nstr=4, planck=True), {}),
    "flux_nstr8": (dict(nstr=8), {}),
    "flux_nstr8_planck": (dict(nstr=8, planck=True), {}),
    "flux_nstr16": (dict(nstr=16, nlyr=3), {}),
    "flux_nstr16_planck": (dict(nstr=16, nlyr=3, planck=True), {}),
    "radiance_nstr4": (dict(nstr=4, mode="radiance"), {}),
    "radiance_nstr16": (dict(nstr=16, nlyr=3, mode="radiance"), {}),
    "radiance_nstr8_hapke_planck": (
        dict(nstr=8, nlyr=3, mode="radiance", brdf="hapke", planck=True),
        {}),
    "G1": (dict(nstr=16, nlyr=3, mode="all_modes"), {}),
    "G2": (dict(nstr=8, nlyr=3, mode="all_modes"), {}),
    "G2_scan": (dict(nstr=8, nlyr=3, mode="all_modes"),
                dict(bvp_method="scan")),
    "G3": (dict(nstr=4, mode="all_modes"), {}),
    "G4": (dict(nstr=6, planck=True), {}),
    "G5": (dict(nstr=10, nlyr=3, mode="radiance"), {}),
    "G6": (dict(nstr=8, brdf="hapke"), {}),
    "G7": (dict(nstr=20, nlyr=3), {}),
    "G8": (dict(nstr=18, nlyr=3), {}),
    "G8_scan": (dict(nstr=18, nlyr=3), dict(bvp_method="scan")),
    "G9": (dict(nstr=32, nlyr=2, mode="radiance"), {}),
}


def _cell(name):
    pargs, extra = CELLS[name]
    args, kw = _as_inputs(*generic_problem(**pargs), F32)
    path = route(nstr=kw["nstr"], onlyfl=kw["onlyfl"], brdf=kw.get("brdf"),
                 umu=kw.get("umu"), phi=kw.get("phi"))

    def body():
        return solve_rte(*args, dtype=F32, device="cpu", **kw, **extra)

    return path, kw["nstr"], body


def _equal(a, b):
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("name", list(CELLS))
def test_capture_rehearsal(name, monkeypatch):
    path, nstr, body = _cell(name)
    want_path = {"flux": "flux_lane", "radi": "radiance_lane"}.get(
        name[:4], "generic")
    assert path == want_path
    assert graph_ok(path, nstr, F32, CUDA), eager_reason(path, nstr, F32,
                                                         CUDA)
    first = body()                     # the warm-up makes the constants
    with monkeypatch.context() as mp:
        refuse_host_transfers(mp)
        again = body()
    _equal(again, first)


def test_rehearsal_sees_constant_transfers(monkeypatch):
    """With the constant cache emptied, the rehearsed body makes its
    tables again from host data, and the rehearsal refuses it."""
    _, _, body = _cell("radiance_nstr4")
    body()
    monkeypatch.setattr(graph, "_consts", type(graph._consts)())
    with monkeypatch.context() as mp:
        refuse_host_transfers(mp)
        with pytest.raises(HostTransfer):
            body()


class Recording(graph.CapturedCall):
    """A CapturedCall that keeps its last inputs."""
    made = []

    def __init__(self, fn, *, capture):
        super().__init__(fn, capture=capture)
        Recording.made.append(self)

    def __call__(self, inputs):
        self.last = inputs
        return super().__call__(inputs)


RAD_CFG = dict(idatm=2, wlinf=0.50, wlsup=0.70, wlinc=0.05, sza=40.0,
               albcon=0.1, nstr=4, iout=20, nzen=3, uzen=[0, 60, 120],
               nphi=2, phi=[0, 90])


def test_pipeline_chunk_solve_rehearsal(monkeypatch):
    """The chunk solve `_captured_solver` holds, on its last chunk's
    inputs, with Planck on (a 1.9-2.2 um grid crosses 2 um) and
    radiances."""
    pipeline._captured_solver.cache_clear()
    Recording.made.clear()
    monkeypatch.setattr(pipeline, "CapturedCall", Recording)
    cfg = Config(**dict(RAD_CFG, wlinf=1.9, wlsup=2.2)).validate()
    pipeline.run_pipeline(cfg, chunk=3, dtype=F32, device="cpu")
    (rec,) = Recording.made
    assert rec.calls == 3 and not rec.capture
    first = rec.fn(**rec.last)
    with monkeypatch.context() as mp:
        refuse_host_transfers(mp)
        again = rec.fn(**rec.last)
    _equal(again, first)
    pipeline._captured_solver.cache_clear()


BATCH_CFG = dict(idatm=2, wlinf=1.8, wlsup=2.3, wlinc=0.05, nstr=4,
                 albcon=0.2, tcloud=[5.0, 0, 0, 0, 0],
                 zcloud=[2.0, 0, 0, 0, 0], iaer=1)


def _perturbed(n, seed=0):
    rng = np.random.default_rng(seed)
    return dict(csza=rng.uniform(0.2, 1.0, n),
                gas_scale=rng.uniform(0.8, 1.2, n),
                cld_scale=rng.uniform(0.5, 1.5, n),
                aer_scale=rng.uniform(0.5, 1.5, n),
                albedo_scale=rng.uniform(0.5, 1.5, n))


def test_batch_band_chunk_solve_rehearsal(monkeypatch):
    """build_batch_fn's captured body, one band chunk's solve (the Planck
    source on), on the last band chunk's tables with host transfers
    refused after the run's warm-up."""
    fn, meta = build_batch_fn(Config(**BATCH_CFG), band_chunk=4, dtype=F32,
                              device="cpu")
    fn(_perturbed(6))
    (solver,) = meta["solvers"].values()
    assert solver.calls == 3 and not solver.capture
    inputs = {k: torch.as_tensor(v, dtype=F32)
              for k, v in _perturbed(6, seed=1).items()}
    inputs.update((k, v[-1]) for k, v in meta["stacked"].items())
    first = solver.fn(**inputs)
    with monkeypatch.context() as mp:
        refuse_host_transfers(mp)
        again = solver.fn(**inputs)
    _equal(again, first)


def test_captured_solver_key_is_the_jitted_solvers():
    ref = list(inspect.signature(ref_pipeline._jitted_solver).parameters)
    ours = list(inspect.signature(pipeline._captured_solver).parameters)
    assert ref == ["nstr", "onlyfl", "planck", "deltam", "corint", "numu",
                   "nphi", "dtype_name"]
    assert ours == ref + ["umu", "phi", "shapes", "device"]


def _key(cfg, inputs, dtype=F64):
    umu, phi = pipeline.user_angles(cfg)
    wl = pipeline.spectral_grid(cfg)
    return pipeline.solver_key(
        cfg, onlyfl=umu is None,
        planck=bool(pipeline.thermal_mask(cfg, wl).any()), umu=umu, phi=phi,
        dtype=dtype, inputs=inputs, device="cpu")


def test_solver_key_ignores_the_data():
    rng = np.random.default_rng(0)

    def inputs():
        return {k: torch.as_tensor(rng.uniform(size=s)) for k, s in
                (("dtau", (3, 3, 5)), ("fbeam", (3, 1)), ("umu0", ()))}

    base = Config(**RAD_CFG).validate()
    key = _key(base, inputs())
    # the reference's static arguments, as its run_pipeline passes them
    umu, phi = pipeline.user_angles(base)
    assert key[:8] == (4, False, False, base.deltam, base.corint, 3, 2,
                       "float64")
    assert key[8] == tuple(np.round(umu, 10)) and key[9] == tuple(phi)
    assert key[10] == (("dtau", (3, 3, 5)), ("fbeam", (3, 1)),
                       ("umu0", ()))
    for data in (dict(sza=10.0), dict(albcon=0.5), dict(phi0=30.0),
                 dict(fisot=1.0), dict(temis=0.3), dict(idatm=4),
                 dict(wlinf=0.55, wlsup=0.75)):
        assert _key(base.replace(**data), inputs()) == key, data
    for static in (dict(nstr=8), dict(deltam=False), dict(corint=False),
                   dict(uzen=[0, 60, 130]), dict(nphi=1)):
        assert _key(base.replace(**static), inputs()) != key, static
    assert _key(base, inputs(), dtype=F32) != key
    assert _key(base, {"dtau": torch.zeros(4, 3, 5)}) != key


@pytest.mark.parametrize("route_, nstr, dtype, device, captured", [
    ("flux_lane", 4, F32, "cpu", False),
    ("flux_lane", 4, F64, "cpu", False),
    ("generic", 10, F32, "cpu", False),
    ("flux_lane", 4, F32, "cuda", True),
    ("flux_lane", 16, F32, "cuda", True),
    ("radiance_lane", 4, F32, "cuda", True),
    ("radiance_lane", 16, F32, "cuda", True),
    ("generic", 2, F32, "cuda", True),
    ("generic", 20, F32, "cuda", True),
    ("generic", 32, F32, "cuda", True),
    ("generic", 34, F32, "cuda", False),
    ("generic", 128, F32, "cuda", False),
    ("flux_lane", 4, F64, "cuda", False),
    ("radiance_lane", 16, F64, "cuda", False),
    ("generic", 6, F64, "cuda", False),
])
def test_graph_ok_rule(route_, nstr, dtype, device, captured):
    assert graph_ok(route_, nstr, dtype, device) is captured
    reason = eager_reason(route_, nstr, dtype, device)
    assert (reason is None) is captured
    if not captured:
        assert reason.split(":")[0] in ("cpu", "float64", "generic N > 16")


def _close(got, want, fields):
    for f in fields:
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert g.shape == w.shape and np.isfinite(g).all(), f
        assert np.abs(g - w).max() <= 1e-9 * np.abs(w).max(), f


def test_multichunk_radiance_pipeline_matches_reference():
    """Three chunks of 2 (the last padded to the chunk shape), iout=20 at
    3 x 2 views: the cached chunk solver is reused by a second run of
    another solar zenith, and both runs match the reference's."""
    pipeline._captured_solver.cache_clear()
    fields = ("fdir", "fdn", "fup", "dfdt", "uavg", "uu")
    for sza in (40.0, 60.0):
        cfg = dict(RAD_CFG, sza=sza, wlsup=0.7)
        want = ref_pipeline.run_pipeline(RefConfig(**cfg).validate(),
                                         chunk=2)
        got = pipeline.run_pipeline(Config(**cfg).validate(), chunk=2,
                                    dtype=F64, device="cpu")
        _close(got, want, fields)
    info = pipeline._captured_solver.cache_info()
    assert (info.misses, info.hits) == (1, 1)
    pipeline._captured_solver.cache_clear()


def test_run_batch_two_column_chunks_matches_reference():
    params = _perturbed(10, seed=3)
    want = ref_run_batch(RefConfig(**BATCH_CFG), RefColumnBatch(**params),
                         mesh=ref_make_mesh(1), band_chunk=4, col_chunk=4)
    got = run_batch(Config(**BATCH_CFG), ColumnBatch(**params), band_chunk=4,
                    col_chunk=4, dtype=F64, device="cpu")
    _close(got, want, ("fdir", "fdn", "fup"))


def test_const_keeps_every_entry(monkeypatch):
    """A graph reads its constants by address: no number of later
    constants drops one."""
    monkeypatch.setattr(graph, "_consts", {})
    first = graph.const(np.arange(4.0), F32, "cpu")
    for i in range(2048):
        graph.const(np.full(3, float(i)), F32, "cpu")
    assert graph.const(np.arange(4.0), F32, "cpu") is first
    assert len(graph._consts) == 2049


class StandIn:
    """What graph_cache reads of a CapturedCall."""

    def __init__(self, key, pool, device="cuda:0"):
        self.key, self.pool_bytes = key, pool
        self.device = torch.device(device)
        self.graph = None
        self.before_capture = None

    def capture(self):
        self.before_capture(self.device)
        self.graph = object()


def _stand_in_cache(monkeypatch, budget, maxsize=32, pools=None):
    monkeypatch.setattr(graph, "pool_budget", lambda device: budget)

    @graph.graph_cache(maxsize=maxsize)
    def make(key, device="cuda:0"):
        """Makes a stand-in."""
        return StandIn(key, (pools or {}).get(key, 4), device)

    return make


@pytest.mark.parametrize("touch, kept", [
    (None, ["b", "c", "d"]),     # a, the oldest, dropped
    ("a", ["c", "a", "d"]),      # a used last: b dropped
])
def test_graph_cache_drops_least_recent_pools_past_the_budget(
        monkeypatch, touch, kept):
    make = _stand_in_cache(monkeypatch, budget=9)
    for k in "abc":
        make(k).capture()        # before c: pools 8 <= 9
    if touch:
        make(touch)
    make("d").capture()          # before d: pools 12 > 9, then 8
    assert [c.key for c in make.entries()] == kept
    assert make.__doc__ == "Makes a stand-in."


def test_graph_cache_keeps_uncaptured_and_other_devices(monkeypatch):
    make = _stand_in_cache(monkeypatch, budget=0,
                           pools={"big": 100, "other": 100})
    make("other", "cuda:1").capture()
    make("warm")                 # a warm-up only: no pool yet
    make("big").capture()
    make("next").capture()       # drops "big", the only pool on cuda:0
    assert [c.key for c in make.entries()] == ["other", "warm", "next"]


def test_graph_cache_counts_and_bounds_keys(monkeypatch):
    make = _stand_in_cache(monkeypatch, budget=10**12, maxsize=2)
    a = make("a")
    assert make("a") is a
    make("b")
    make("c")
    assert [c.key for c in make.entries()] == ["b", "c"]
    assert tuple(make.cache_info()) == (1, 3, 2, 2)
    make.cache_clear()
    assert tuple(make.cache_info()) == (0, 0, 2, 0)
