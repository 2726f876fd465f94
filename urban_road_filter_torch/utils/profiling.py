"""Tracing and profiling hooks (the reference has none).

Port of urban_road_filter_tpu/utils/profiling.py:

  * ``StageTimers``: wall-clock stage timers for the host loop (a copy);
  * ``device_trace``: torch.profiler around a block, CPU and CUDA
    activities, writing a Chrome / Perfetto trace into a directory;
  * ``annotate``: a named range (``record_function``) in the trace.

The pipeline names its stages ``urf::<stage>`` (pipeline._stage), and
while a profiler runs each kernel launch sits in a ``urf::k::<kernel>``
range inside its stage's (_build.launch).  The profiler links a ctypes
launch to the innermost such range, and only on the device timeline: the
range's projection there spans the device ops launched directly inside
it, while a CPU op's device time and the enclosing stage's projection
leave the kernel out.  ``stage_device_time`` therefore rebuilds each
stage's window on the device from its own projection and its launches',
and credits every device op to the window that holds it.
"""

from __future__ import annotations

import bisect
import contextlib
import os
import time
from collections import defaultdict
from typing import Iterator

import torch


class StageTimers:
    """Accumulating wall-clock timers: `with timers.stage("tensorize"): ...`"""

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        return {k: {"total_s": round(v, 4),
                    "mean_ms": round(1e3 * v / max(self.counts[k], 1), 3),
                    "calls": self.counts[k]}
                for k, v in sorted(self.totals.items())}


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the block with torch.profiler (CPU activities, and CUDA ones
    when a card is present; the device is synchronised before the profiler
    stops) and write its Chrome / Perfetto trace into ``logdir`` as
    ``urf.<pid>.<ns>.pt.trace.json``.  Yields the profiler, whose
    ``events()`` and ``key_averages()`` the caller may read after the
    block."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"urf.{os.getpid()}.{time.time_ns()}.pt.trace.json"))


def credit(ops, ranges) -> dict:
    """{label: [device us, count]} of the device ops, (start, end) pairs,
    that start inside each range, (start, end, label), of ranges that do
    not overlap."""
    ranges = sorted(ranges)
    starts = [r[0] for r in ranges]
    out = {}
    for s, e in ops:
        k = bisect.bisect_right(starts, s) - 1
        if k >= 0 and s < ranges[k][1]:
            acc = out.setdefault(ranges[k][2], [0.0, 0])
            acc[0] += e - s
            acc[1] += 1
    return out


def _stage_of(e):
    """The urf::<stage> range around a CPU event, or None."""
    p = e.cpu_parent
    while p is not None and (not p.name.startswith("urf::")
                             or p.name.startswith("urf::k::")):
        p = p.cpu_parent
    return p


def stage_device_time(events) -> dict:
    """Device time per pipeline stage from a profiler's ``events()``:
    {stage: {"device_us", "ops", "windows": [(start, end)], "kernels":
    {kernel: [device us, launches]}, "unmatched"}}, "(outside)" for
    launches outside every stage.  A stage's window on the device timeline
    is the hull of its range's projection and those of the urf::k::<kernel>
    ranges of its launches (the n-th range of a name on the host paired
    with its n-th projection: one stream); each device op (kernel, copy,
    memset) is credited to the window that holds its start, a kernel's to
    its launch.  A stage range that launched no device op of its own has
    no projection at all, and its window is its launches'.  Where the
    profiler lost an event, a name's host ranges and projections differ in
    number and none of them can be paired: a stage's "unmatched" counts
    its ranges (its own and its launches') left so, and a stage with any
    has device time that is too low."""
    from torch.autograd import DeviceType

    def by_name(evs):
        out = {}
        for e in sorted(evs, key=lambda e: e.time_range.start):
            out.setdefault(e.name, []).append(e)
        return out

    host = [e for e in events if e.device_type == DeviceType.CPU
            and e.name.startswith("urf::")]
    dev = by_name(e for e in events if e.device_type == DeviceType.CUDA
                  and e.name.startswith("urf::"))
    ops = [(e.time_range.start, e.time_range.end) for e in events
           if e.device_type == DeviceType.CUDA
           and not e.name.startswith("urf::")]
    proj = {}  # id(host range) -> its projection
    lost = set()  # names whose ranges and projections differ in number
    for name, evs in by_name(host).items():
        spans = dev.get(name, [])
        if len(spans) == len(evs):
            for e, s in zip(evs, spans):
                proj[id(e)] = (s.time_range.start, s.time_range.end)
        elif spans or name.startswith("urf::k::"):
            lost.add(name)
    windows = {}  # id(stage's host range) -> [start, end, stage]
    launches = []  # (start, end, (stage, kernel))
    out = {}
    for e in host:
        is_k = e.name.startswith("urf::k::")
        st = _stage_of(e) if is_k else e
        stage = "(outside)" if st is None else st.name[5:]
        rec = out.setdefault(stage, {"device_us": 0.0, "ops": 0,
                                     "windows": [], "kernels": {},
                                     "unmatched": 0})
        if is_k:
            rec["kernels"].setdefault(e.name[8:], [0.0, 0])[1] += 1
        span = proj.get(id(e))
        if span is None:
            rec["unmatched"] += e.name in lost
            continue
        if is_k:
            launches.append((*span, (stage, e.name[8:])))
        if st is not None:
            w = windows.setdefault(id(st), [*span, stage])
            w[0], w[1] = min(w[0], span[0]), max(w[1], span[1])
    for (stage, kernel), (us, _) in credit(ops, launches).items():
        out[stage]["kernels"][kernel][0] += us
    for stage, (us, count) in credit(ops, windows.values()).items():
        out[stage]["device_us"] += us
        out[stage]["ops"] += count
    for s, e, stage in sorted(windows.values()):
        out[stage]["windows"].append((s, e))
    return out


def annotate(name: str):
    """A named range in the trace viewer (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)


__all__ = ["StageTimers", "device_trace", "annotate", "stage_device_time"]
