"""The traced span of a `--trace 1` run: torch.profiler (CUPTI) over a
short steady part of the window, reduced to plain lists the per-layer
readers take.

  device       (name, start_ns, end_ns) of every device operation
               (kernels, copies, fills), the harness's own annotations
               on the device timeline left out;
  runtime      {name: count} of CUDA runtime calls (cudaGraphLaunch ...);
  spans        (name, start_ns, end_ns) of the harness's annotations
               (record_function names starting "rtbench."), in the
               profiler's clock;
  window_s     the traced span's length on the host clock.

Frozen: later changes add metric readers, and do not edit this file.
"""

from __future__ import annotations

import time

ANNOTATION = "rtbench."


class Trace:
    def __init__(self):
        self.device: list = []
        self.runtime: dict = {}
        self.spans: list = []
        self.window_s = 0.0
        self._prof = None
        self._t0 = 0.0

    def start(self, torch) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._card = torch.cuda.is_available()
        if self._card:
            torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU]
                             + [ProfilerActivity.CUDA] * self._card)
        self._prof.start()
        self._t0 = time.perf_counter()
        self._mark = torch.profiler.record_function(ANNOTATION + "traced")
        self._mark.__enter__()

    def stop(self, torch) -> None:
        if self._card:
            torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self.window_s = time.perf_counter() - self._t0
        self._prof.stop()
        self._read(torch)
        self._prof = None

    def _read(self, torch) -> None:
        cuda = torch.autograd.DeviceType.CUDA
        try:
            raw = self._prof.profiler.kineto_results.events()
            events = [(e.name(), e.device_type() == cuda, e.start_ns(),
                       e.start_ns() + e.duration_ns()) for e in raw]
        except AttributeError:
            events = [(e.name, e.device_type == cuda,
                       e.time_range.start * 1000, e.time_range.end * 1000)
                      for e in self._prof.events()]
        # a range the host opened (record_function, a collective's
        # "nccl:all_reduce") shows on the device's timeline under the same
        # name; it is not an operation
        host_names = {name for name, on_card, _, _ in events if not on_card}
        for name, on_card, t0, t1 in events:
            if name.startswith(ANNOTATION):
                if not on_card:
                    self.spans.append((name, t0, t1))
            elif on_card:
                if name not in host_names:
                    self.device.append((name, t0, t1))
            elif name.startswith("cuda"):
                self.runtime[name] = self.runtime.get(name, 0) + 1
        self.device.sort(key=lambda e: e[1])

    # ---- reductions -----------------------------------------------------
    def bounds(self) -> tuple[int, int]:
        """The traced span in the profiler's clock (ns)."""
        (span,) = [s for s in self.spans if s[0] == ANNOTATION + "traced"]
        return span[1], span[2]

    def busy_ns(self, lo: int | None = None, hi: int | None = None,
                skip=None) -> int:
        """Nanoseconds in which some device operation ran (the union over
        streams), within [lo, hi] where given, leaving out the operations
        whose name `skip` (a callable) accepts."""
        total, end = 0, None
        for name, t0, t1 in self.device:
            if skip is not None and skip(name):
                continue
            if lo is not None:
                t0, t1 = max(t0, lo), min(t1, hi)
                if t1 <= t0:
                    continue
            if end is None or t0 > end:
                total += t1 - t0
                end = t1
            elif t1 > end:
                total += t1 - end
                end = t1
        return total

    def device_ns(self, match) -> int:
        """Summed durations of the device operations whose name `match`
        (a callable) accepts."""
        return sum(t1 - t0 for name, t0, t1 in self.device if match(name))

    def gaps(self) -> list:
        """(start_ns, end_ns) of every interval of the traced span in which
        no device operation ran."""
        lo, hi = self.bounds()
        out, cur = [], lo
        for _, t0, t1 in self.device:
            if t1 <= cur:
                continue
            if t0 > cur:
                out.append((cur, min(t0, hi)))
            cur = max(cur, t1)
            if cur >= hi:
                break
        if cur < hi:
            out.append((cur, hi))
        return [g for g in out if g[1] > g[0]]

    def host_doing(self, t0: int, t1: int) -> str:
        """The innermost harness span around the middle of [t0, t1] (what
        the host was doing there), or "outside spans"."""
        mid = (t0 + t1) // 2
        best = None
        for name, s0, s1 in self.spans:
            if s0 <= mid <= s1 and (best is None or s1 - s0 < best[1]):
                best = (name[len(ANNOTATION):], s1 - s0)
        return best[0] if best else "outside spans"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (seconds, summed by
        name) and the longest idle gaps by what the host was doing."""
        by = {}
        for name, t0, t1 in self.device:
            by[name] = by.get(name, 0) + (t1 - t0)
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:200], ns / 1e9] for n, ns in ops],
                "idle_gaps": [[self.host_doing(a, b), (b - a) / 1e9]
                              for a, b in gaps]}
