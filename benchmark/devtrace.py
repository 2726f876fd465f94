"""The traced segment: torch.profiler over a fixed number of calls after
the measured window, reduced to device intervals by kind.

Device rows are the port's own kernels (matched by their ``__global__``
names, ``kernels.json``), other kernels (the glue: PyTorch's kernels
between the port's), memcpy and memset rows.  The profiler's projections
of named ranges onto the device timeline (``urf::`` stages, ``bench::``
spans) are not device work and are left out.  Idle gaps are named by the
innermost host event running at the gap's middle.
"""

from __future__ import annotations

import bisect
import functools
import json
import re
import time
from collections import defaultdict
from pathlib import Path

_OWN = None


def own_kernels() -> dict:
    """{__global__ name: stage} of the port's kernels."""
    global _OWN
    if _OWN is None:
        path = Path(__file__).resolve().parent / "kernels.json"
        _OWN = json.loads(path.read_text())["kernels"]
    return _OWN


def kernel_stage(name: str):
    """The stage of a device kernel's (demangled) name when it is one of
    the port's own kernels, else None."""
    for k, stage in own_kernels().items():
        if re.search(rf"(^|[\s:*&]){k}(<|\(|$)", name):
            return stage
    return None


@functools.lru_cache(maxsize=4096)
def kind_of(name: str) -> str:
    """"memcpy", "memset", "own" (the port's kernels) or "glue"."""
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "own" if kernel_stage(name) is not None else "glue"


def union_s(intervals) -> float:
    """Seconds covered by the union of (start, end) intervals in us."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total * 1e-6


class Trace:
    """A traced segment's device rows and host events.

    ``device``: [(start us, end us, name, kind)]; ``host``: [(start us,
    end us, name)] sorted by start; ``window_s``: the segment's host
    length; ``scans``: the scans its calls completed."""

    def __init__(self, device, host, window_s: float, scans: int):
        self.device = sorted(device)
        self.host = sorted(host)
        self._starts = [h[0] for h in self.host]
        self.window_s = window_s
        self.scans = scans

    def seconds(self, *kinds) -> float:
        return sum(e - s for s, e, _, k in self.device if k in kinds) * 1e-6

    def busy_s(self) -> float:
        return union_s((s, e) for s, e, _, _ in self.device)

    def top_ops(self, n: int = 10) -> list:
        by = defaultdict(float)
        for s, e, name, _ in self.device:
            by[name] += (e - s) * 1e-6
        return sorted(([k[:200], v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def gaps(self):
        """(start us, end us) of each stretch with no device row, between
        the first row and the last."""
        out, end = [], None
        for s, e, _, _ in self.device:
            if end is not None and s > end:
                out.append((end, s))
            end = e if end is None else max(end, e)
        return out

    def host_at(self, t: float) -> str:
        """The innermost host event running at t (us)."""
        i = bisect.bisect_right(self._starts, t)
        best = None
        for j in range(i - 1, max(i - 400, -1), -1):
            s, e, name = self.host[j]
            if e >= t and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        return "host idle" if best is None else best[2]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle device time summed by what the host was doing, largest
        first."""
        by = defaultdict(float)
        for s, e in self.gaps():
            by[self.host_at(0.5 * (s + e))] += (e - s) * 1e-6
        return sorted(([k[:200], v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]


def record(call, n_calls: int, scans_per_call: int) -> Trace:
    """Profile ``n_calls`` calls of ``call(i)`` (CPU and CUDA activities)
    and reduce them.  A short profiled run first starts the profiler's
    device tracing, so the segment holds no start-up."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        call(0)
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(n_calls):
            call(i)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    device, host = [], []
    for name, dev_type, s, t, note in _events(prof):
        if dev_type == DeviceType.CUDA:
            if not note and not name.startswith(("urf::", "bench::")):
                device.append((s, t, name, kind_of(name)))
        elif dev_type == DeviceType.CPU:
            host.append((s, t, name))
    return Trace(device, host, window_s, n_calls * scans_per_call)


def _events(prof):
    """(name, device type, start us, end us, is a range's projection) of
    every profiled event, from the profiler's raw results (building its
    event tree takes minutes over some 10^5 events)."""
    for e in prof.profiler.kineto_results.events():
        yield (e.name(), e.device_type(), e.start_ns() / 1e3,
               e.end_ns() / 1e3, e.is_user_annotation())
