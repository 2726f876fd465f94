"""Tracing and profiling hooks (the reference has none).

Port of urban_road_filter_tpu/utils/profiling.py, with the port's own
tracing inside its compiled entries.  The port traces only while a torch
profiler records (``_build._profiling``, one C call, the switch that also
gates the kernels' ``urf::k::<kernel>`` ranges in _build.launch); with no
profiler nothing is entered and nothing is recorded.

  * ``device_trace``: torch.profiler around a block, CPU and CUDA
    activities, writing a Chrome / Perfetto trace into a directory;
  * ``span``: a named range (``record_function``) in the trace;
  * ``stage``: a pipeline stage's range (pipeline._stage), and inside a
    traced capture its timing events;
  * the replay record (``replay_record``, ``flush``): the device time of
    the compiled entries' traced replays, by stage.

The ranges:

  urf::<stage>         a pipeline stage, in an eager run or a capture
  urf::k::<kernel>     one kernel launch inside its stage
  urf::entry.<kind>    one call of a compiled entry (pipeline's "scan",
                       "packed", "batch"; the SP run's "sp"), from the
                       call to its return; args: the call's number among
                       its kind's traced calls.  Inside it, with the same
                       args:
    urf::stage_read    the previous traced replay's events read
    urf::copy_in       the input copied into the entry's buffer (a batch
                       in lane groups: the groups' copies enqueued)
    urf::launch        the graph's replay (on the CPU, the body's run)
    urf::clone         the outputs' clones (lane groups: each group's
                       outputs written into the call's fields)

A CUDA-graph replay runs no Python, so a replay has no stage ranges.
Instead each compiled entry captures, on its first call while tracing, a
second, traced variant of its body whose stages record timing events
(CUDA event-record nodes, no device row) at their entry and exit, and one
each before and after the body; traced calls replay it, and the entry
reads a replay's events at its next traced call, once the last has
completed (``ReplayRecord``).  A stage entered more than once in a body
(the batch entry's lane groups) is timed each time, and its times add.

The profiler links a ctypes launch to the innermost range, and only on
the device timeline: the range's projection there spans the device ops
launched directly inside it, while a CPU op's device time and the
enclosing stage's projection leave the kernel out.  ``stage_device_time``
therefore rebuilds each eager stage's window on the device from its own
projection and its launches', and credits every device op to the window
that holds it.
"""

from __future__ import annotations

import bisect
import contextlib
import os
import time

import torch
from torch.profiler import record_function

from urban_road_filter_torch import _build

_NULL = contextlib.nullcontext()


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


def span(name: str, args: str | None = None):
    """A named range in the trace (record_function, ``args`` its
    identifier) while a profiler records; a null context otherwise."""
    return record_function(name, args) if _build._profiling() else _NULL


# The [(stage, start, end)] events of the traced capture under way, or None.
_marks: list | None = None


def stage(name: str):
    """The range of pipeline stage ``name``, ``urf::<name>``, while a
    profiler records; inside a traced capture (``timed_capture``) also a
    timing event on the capturing stream at the stage's entry and one at
    its exit."""
    if _marks is None:
        return span("urf::" + name)
    return _timed_stage(name)


@contextlib.contextmanager
def _timed_stage(name: str):
    marks = _marks
    with span("urf::" + name):
        start = _event()
        yield
        marks.append((name, start, _event()))


def _event():
    """A timing event recorded on the current stream: inside a capture,
    an event-record node of the graph."""
    ev = torch.cuda.Event(enable_timing=True, external=True)
    ev.record()
    return ev


class StageEvents:
    """The timing events of one traced capture of an entry of ``kind``:
    ``first`` and ``last`` around the body, ``stages`` [(stage, start,
    end)] in the body's order.  Each replay of the graph records them
    anew."""

    def __init__(self, kind: str, first):
        self.kind = kind
        self.first = first
        self.last = None
        self.stages: list = []


@contextlib.contextmanager
def timed_capture(kind: str):
    """Around the body of a CUDA-graph capture: the stages entered inside
    record their timing events, and the body gets one event before it and
    one after.  Yields the StageEvents."""
    global _marks
    if _marks is not None:
        raise RuntimeError("a traced capture is already under way")
    events = StageEvents(kind, _event())
    _marks = events.stages
    try:
        yield events
    finally:
        _marks = None
    events.last = _event()


class ReplayRecord:
    """Device time inside the compiled entries' traced replays, per entry
    kind (``totals``): "calls", the traced calls; "timed", the replays
    whose events were read; "untimed", the replays whose events the next
    replay of their graph overwrote before they had completed;
    "stage_ms", {stage: device ms from its entry event to its exit event,
    summed over the timed replays}; "replay_ms", device ms from the body's
    first event to its last, summed.  A replay is ``pending`` from its
    launch until its events are read."""

    def __init__(self):
        self.kinds: dict = {}
        self.pending: list = []

    def _kind(self, kind: str) -> dict:
        return self.kinds.setdefault(kind, {
            "calls": 0, "timed": 0, "untimed": 0, "stage_ms": {},
            "replay_ms": 0.0})

    def call(self, kind: str) -> str:
        """Count a traced call of ``kind``; its number, as span args."""
        rec = self._kind(kind)
        rec["calls"] += 1
        return str(rec["calls"])

    def replayed(self, events: StageEvents) -> None:
        """A replay of the graph that records ``events`` was launched."""
        self.pending.append(events)

    def settle(self, events: StageEvents) -> None:
        """Before the graph that records ``events`` replays again: read its
        pending replay if the last event has completed, else count it as
        untimed.  Never waits."""
        for k, ev in enumerate(self.pending):
            if ev is events:
                del self.pending[k]
                self._read(events, wait=False)
                return

    def flush(self) -> None:
        """Read every pending replay, waiting for its last event."""
        while self.pending:
            self._read(self.pending.pop(0), wait=True)

    def _read(self, events: StageEvents, wait: bool) -> None:
        rec = self._kind(events.kind)
        if wait:
            events.last.synchronize()
        elif not events.last.query():
            rec["untimed"] += 1
            return
        ms = rec["stage_ms"]
        for name, start, end in events.stages:
            ms[name] = ms.get(name, 0.0) + start.elapsed_time(end)
        rec["replay_ms"] += events.first.elapsed_time(events.last)
        rec["timed"] += 1

    def totals(self) -> dict:
        return {kind: dict(rec, stage_ms=dict(rec["stage_ms"]))
                for kind, rec in self.kinds.items()}


# The process's record.  It outlives the entries: an SP run may be freed
# before its last replay is read.
RECORD = ReplayRecord()


def replay_record() -> dict:
    """{entry kind: totals} of the process's traced replays
    (ReplayRecord), pending ones left out until ``flush``."""
    return RECORD.totals()


def flush() -> None:
    """Read the process's pending traced replays, waiting for them."""
    RECORD.flush()


def entry_call(kind: str) -> str | None:
    """While a profiler records, count a call of a compiled entry of
    ``kind`` and return its number; None otherwise (the entries' only
    test of the switch when no profiler runs)."""
    return RECORD.call(kind) if _build._profiling() else None


def entry_span(kind: str, call: str | None):
    """``urf::entry.<kind>`` with args ``call`` (entry_call's), or a null
    context where ``call`` is None."""
    return _NULL if call is None else record_function(
        f"urf::entry.{kind}", call)


__all__ = ["RECORD", "ReplayRecord", "StageEvents", "device_trace",
           "entry_call", "entry_span", "flush", "replay_record", "span",
           "stage", "stage_device_time", "timed_capture"]
