"""Captured solves: the port's counterpart of the JAX package's compiled
chunk solve.

The reference never runs its solve op by op: `_jitted_solver`
(sbdart_tpu/pipeline.py:100-121) compiles one executable per static
configuration and every chunk replays it, and the batch jits its whole
spectral loop (sbdart_tpu/batch.py:275-296).  PyTorch's counterpart is a
CUDA graph: the solve is captured once for a static configuration and
input shape, and every later call copies its inputs into the graph's
static buffers and replays it, one launch for the thousands of device
operations that eager dispatch would launch one by one.

Capture records device work only, so the captured body must move no data
between host and device once its constants exist: the solver's angular
tables and index arrays come from `const` (a device tensor made once per
value, dtype and device, as jit makes them compile-time constants) and
its scalar arguments from `as_device` (a tensor passes through, a Python
number is filled on the device).

Which calls capture is the caller's fixed rule, never a caught error
(`CapturedCall`'s `capture`; the solver's is solver/disort.py:graph_ok):

  | capture | first call                   | second call                  | later calls |
  | ------- | ---------------------------- | ---------------------------- | ----------- |
  | false   | eager, on the current stream | eager                        | eager       |
  | true    | eager warm-up, side stream   | capture, instantiate, replay | replay      |

A capture that fails where the caller's rule admits it raises.  The
process counters (tracing.py) the captured function moves are set back
after the capture and added again on each replay, so a kernel wrapper's
`kernels.<wrapper>.launches` counts the launches a replay makes.

A graph reads its constants by address: `const` keeps every tensor it
made (its keys are static configurations: tables, index arrays, angle
sets), and a CapturedCall holds the constants that existed at its
capture, so none is freed under a graph.  `graph_cache` bounds what the
graphs hold: at most `maxsize` keys, and before each capture it drops the
least recently used captured graphs until the pools of those left on the
device hold at most POOL_SHARE of its memory (a dropped graph's pool goes
back to the device at that capture).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import gc
import time
from typing import Callable

import numpy as np
import torch

from sbdart_tpu_torch import tracing

POOL_SHARE = 0.25
_consts: dict = {}


def const(x, dtype=None, device=None) -> torch.Tensor:
    """Host data (a NumPy array, list or number) as a tensor on `device`
    in `dtype` (None: the data's own), made once per value, dtype and
    device and kept for the life of the process: callers must not write
    into it.  The values are torch.as_tensor's, so a cached table is the
    one the eager call made."""
    a = np.asarray(x)
    key = (a.dtype.str, a.shape, a.tobytes(), dtype, torch.device(device))
    t = _consts.get(key)
    if t is None:
        t = _consts[key] = torch.as_tensor(a, dtype=dtype, device=device)
    return t


def index(idx, device) -> torch.Tensor:
    """An integer index array as a cached int64 tensor on `device`:
    indexing with it gathers what indexing with the NumPy array does,
    without copying the index to the device on every call."""
    return const(np.asarray(idx, np.int64), None, device)


def as_device(x, dtype, device) -> torch.Tensor:
    """A solve argument as a tensor of `dtype` on `device`: a tensor is
    cast or moved (itself where it matches), a Python number is filled on
    the device (no host copy; the value torch.as_tensor gives), and other
    host data goes through torch.as_tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype, device=device)
    if isinstance(x, (bool, int, float)):
        return torch.full((), x, dtype=dtype, device=device)
    return torch.as_tensor(x, dtype=dtype, device=device)


class CapturedCall:
    """fn(**inputs) replayed as one CUDA graph.

    `inputs` is a dict of tensors of fixed shapes and dtypes (the caller
    keys a CapturedCall by them).  The first call runs fn eagerly on a
    side stream: the warm-up, whose outputs the caller gets.  The second
    copies its inputs into static buffers, captures fn on that stream,
    instantiates the graph and replays it; every later call copies its
    inputs into the static buffers and replays.  A replay's outputs are
    the graph's own tensors: consume or clone them before the next call.
    The process counters that the capture moved are set back and added
    again on each replay.  With `capture` false every call runs fn
    eagerly on the current stream.

    After capture: `device`, `capture_s` and `instantiate_s` (host
    seconds), `pool_bytes` (the device memory the graph's private pool
    reserved), `replays`, and `node_count()`.  `before_capture`, where
    set, is called with the device just before the capture
    (graph_cache's trim).  Spans (tracing.py): `graph.warmup`,
    `graph.capture` (instantiate included), `graph.replay` (the input
    copies and the replay) and `graph.eager`; counters `graph.captures`,
    `graph.replays` and `graph.eager_calls`."""

    def __init__(self, fn: Callable, *, capture: bool):
        self.fn = fn
        self.capture = capture
        self.calls = 0
        self.replays = 0
        self.graph = None
        self.static_in = None
        self.static_out = None
        self.deltas = ()
        self.device = None
        self.capture_s = self.instantiate_s = None
        self.pool_bytes = None
        self.before_capture = None
        self._consts = ()
        self._stream = None

    def __call__(self, inputs: dict):
        self.calls += 1
        if not self.capture:
            tracing.count("graph.eager_calls")
            with tracing.span("graph.eager"):
                return self.fn(**inputs)
        if self.calls == 1:
            with tracing.span("graph.warmup"):
                return self._warm_up(inputs)
        if self.graph is None:
            with tracing.span("graph.capture"):
                self._capture(inputs)
            tracing.count("graph.captures")
            inputs = {}         # the capture's static inputs hold them
        with tracing.span("graph.replay"):
            for k, v in inputs.items():
                dst = self.static_in[k]
                if v.shape != dst.shape or v.dtype != dst.dtype:
                    raise ValueError(
                        f"captured call: input {k!r} {tuple(v.shape)} "
                        f"{v.dtype} is not the captured {tuple(dst.shape)} "
                        f"{dst.dtype}")
                dst.copy_(v)
            self.graph.replay()
        self.replays += 1
        tracing.count("graph.replays")
        for name, d in self.deltas:
            tracing.count(name, d)
        return self.static_out

    def _side(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        self._stream.wait_stream(torch.cuda.current_stream())
        return self._stream

    def _warm_up(self, inputs):
        side = self._side()
        with torch.cuda.stream(side):
            out = self.fn(**inputs)
        torch.cuda.current_stream().wait_stream(side)
        return out

    def _capture(self, inputs):
        self.static_in = {k: v.clone() for k, v in inputs.items()}
        self.device = next(iter(self.static_in.values())).device
        if self.before_capture is not None:
            self.before_capture(self.device)
        before = tracing.counters()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        side = self._side()
        # no cyclic garbage collection during the capture: it could
        # destroy another graph (a CapturedCall left in a reference
        # cycle), and that graph's CUDA calls would invalidate this capture
        gc_was_enabled = gc.isenabled()
        gc.disable()
        try:
            # thread_local: CUDA refuses this thread's unsafe calls (host
            # syncs, pageable copies) during the capture, not other
            # threads' (an NCCL process group's watchdog polls meanwhile)
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                # entering freed the allocator's cache: what the device
                # reserves from here on is the graph's pool
                reserved = torch.cuda.memory_reserved(self.device)
                t0 = time.perf_counter()
                out = self.fn(**self.static_in)
        finally:
            if gc_was_enabled:
                gc.enable()
        t1 = time.perf_counter()
        graph.instantiate()
        self.instantiate_s = time.perf_counter() - t1
        self.capture_s = t1 - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        # the graph reads its constants by address: hold them
        self._consts = tuple(_consts.values())
        # the capture launched nothing: set the counters back; each replay
        # adds what the capture counted
        self.deltas = tuple((k, v - before.get(k, 0))
                            for k, v in tracing.counters().items()
                            if v != before.get(k, 0))
        for name, d in self.deltas:
            tracing.count(name, -d)
        self.graph, self.static_out = graph, out

    def node_count(self) -> int:
        """The captured graph's node count (cuGraphGetNodes)."""
        if self.graph is None:
            raise ValueError("captured call: nothing captured yet")
        cuda = ctypes.CDLL("libcuda.so.1")
        n = ctypes.c_size_t(0)
        code = cuda.cuGraphGetNodes(ctypes.c_void_p(self.graph.raw_cuda_graph()),
                                    None, ctypes.byref(n))
        if code != 0:
            raise RuntimeError(f"cuGraphGetNodes: CUDA driver error {code}")
        return int(n.value)



CacheInfo = collections.namedtuple("CacheInfo",
                                   "hits misses maxsize currsize")


def pool_budget(device) -> int:
    """The bytes that the pools of a graph_cache's captured graphs on
    `device` may hold before a capture: POOL_SHARE of its memory."""
    return int(POOL_SHARE * torch.cuda.get_device_properties(
        device).total_memory)


def graph_cache(maxsize: int):
    """functools.lru_cache(maxsize) for a function that makes CapturedCalls,
    bounded by their pools too: before one of its calls captures, the
    least recently used captured ones on that device are dropped until
    their pools together hold at most pool_budget(device).  The wrapper
    has lru_cache's `cache_info()` and `cache_clear()`, and `entries()`
    (the cached calls, the least recently used first)."""

    def decorate(make):
        cache = collections.OrderedDict()
        hits = misses = 0

        def trim(device):
            budget = pool_budget(device)
            held = [(k, c) for k, c in cache.items()
                    if c.graph is not None and c.device == device]
            total = sum(c.pool_bytes for _, c in held)
            for k, c in held:
                if total <= budget:
                    break
                del cache[k]
                total -= c.pool_bytes

        @functools.wraps(make)
        def get(*key):
            nonlocal hits, misses
            call = cache.get(key)
            if call is not None:
                hits += 1
                cache.move_to_end(key)
                return call
            misses += 1
            call = cache[key] = make(*key)
            call.before_capture = trim
            if len(cache) > maxsize:
                cache.popitem(last=False)
            return call

        def cache_info():
            return CacheInfo(hits, misses, maxsize, len(cache))

        def cache_clear():
            nonlocal hits, misses
            cache.clear()
            hits = misses = 0

        get.cache_info = cache_info
        get.cache_clear = cache_clear
        get.entries = lambda: list(cache.values())
        return get

    return decorate
