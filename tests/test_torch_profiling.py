"""The port's profiling hooks (urban_road_filter_torch.utils.profiling) on
the CPU: StageTimers' summary against the JAX package's, device_trace
writing a Chrome trace that holds the pipeline's urf::<stage> ranges and
annotate's, the launch wrapper's profiler test (_build._profiling) true
only inside a trace, and stage_device_time's crediting of device ops,
the port's kernels included, to the stage windows that hold them
(tools/profile_torch_scan.py reads it).  On the card, chip_smoke.py
phase 7 holds each kernel launch inside its stage's range."""

import glob
import json

import numpy as np
import pytest
import torch

from urban_road_filter_tpu.utils import profiling as jax_profiling
from urban_road_filter_torch import (
    FilterConfig, PipelineDims, _build, pad_scan, process_scan)
from urban_road_filter_torch.io import SCENES, make_scan
from urban_road_filter_torch.utils import profiling

torch.set_num_threads(1)  # tier-1 runs several pytest workers

DIMS = PipelineDims(max_points=4096, rings=64, ring_capacity=512,
                    beam_capacity=128)
STAGES = ("ingest", "star", "tensorize", "xz_zero", "blind_spots",
          "markers", "gather")


def test_stage_timers_summary(monkeypatch):
    """The same clock readings give the JAX StageTimers' summary."""
    summaries = []
    for mod in (profiling, jax_profiling):
        ticks = iter([0.0, 0.5, 1.0, 1.25, 2.0, 2.125])
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
        t = mod.StageTimers()
        for name in ("tensorize", "ingest", "tensorize"):
            with t.stage(name):
                pass
        summaries.append(t.summary())
    assert summaries[0] == summaries[1]
    assert list(summaries[0]) == ["ingest", "tensorize"]
    assert summaries[0]["tensorize"] == {"total_s": 0.625, "mean_ms": 312.5,
                                         "calls": 2}


def test_stage_timers_count_a_raising_stage():
    t = profiling.StageTimers()
    with pytest.raises(ValueError):
        with t.stage("bad"):
            raise ValueError
    assert t.summary()["bad"]["calls"] == 1


def test_device_trace_writes_the_stage_ranges(tmp_path):
    pts = torch.from_numpy(pad_scan(make_scan(
        SCENES["two_curbs"](), n_rings=16, n_azimuth=192, seed=3),
        DIMS.max_points))
    assert not _build._profiling()
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        assert _build._profiling()
        with profiling.annotate("urf::demo_block"):
            process_scan(pts, FilterConfig(), DIMS, device="cpu")
    assert not _build._profiling()
    files = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    for stage in STAGES:
        assert f"urf::{stage}" in names, stage
    assert "urf::demo_block" in names
    events = {e.name for e in prof.events()}
    assert {f"urf::{s}" for s in STAGES} <= events


def test_device_trace_writes_when_the_block_raises(tmp_path):
    with pytest.raises(RuntimeError):
        with profiling.device_trace(str(tmp_path)):
            torch.ones(3).sum()
            raise RuntimeError("inside the trace")
    assert len(glob.glob(str(tmp_path / "*.pt.trace.json"))) == 1
    assert not _build._profiling()


class _Ev:
    """A profiler event: name, device type, time range and host parent."""

    def __init__(self, name, cuda, start, end, parent=None):
        from torch.autograd import DeviceType

        self.name = name
        self.device_type = DeviceType.CUDA if cuda else DeviceType.CPU
        self.time_range = type("Interval", (), {"start": start, "end": end})
        self.cpu_parent = parent


def test_stage_device_time_takes_in_the_kernels():
    """Two scans' stages as the profiler reports them: a stage's own
    projection leaves out the kernels launched in its urf::k ranges (the
    star stage has none at all); the stage windows take them in, and each
    device op goes to the window holding it, copies outside to none."""
    events = []
    for t in (0.0, 1000.0):
        ingest = _Ev("urf::ingest", False, t, t + 50)
        star = _Ev("urf::star", False, t + 50, t + 60)
        events += [
            ingest, star,
            _Ev("urf::k::ingest_prep", False, t + 1, t + 2, ingest),
            _Ev("urf::k::discover_rings", False, t + 10, t + 11, ingest),
            _Ev("urf::k::star_walk", False, t + 51, t + 52, star),
            _Ev("urf::k::ingest_prep", True, t + 100, t + 103),
            _Ev("urf::ingest", True, t + 104, t + 110),
            _Ev("urf::k::discover_rings", True, t + 111, t + 120),
            _Ev("urf::k::star_walk", True, t + 121, t + 125),
            _Ev("copy", True, t + 90, t + 95),  # H2D, outside the stages
            _Ev("ingest_prep_kernel", True, t + 100, t + 103),
            _Ev("aten_kernel", True, t + 104, t + 110),
            _Ev("memset", True, t + 111, t + 112),
            _Ev("discover_kernel", True, t + 113, t + 120),
            _Ev("star_search_kernel", True, t + 121, t + 125),
        ]
    got = profiling.stage_device_time(events)
    assert set(got) == {"ingest", "star"}
    assert got["ingest"]["device_us"] == 2 * (3 + 6 + 1 + 7)
    assert got["ingest"]["ops"] == 8
    assert got["ingest"]["kernels"] == {"ingest_prep": [6.0, 2],
                                        "discover_rings": [16.0, 2]}
    assert got["ingest"]["windows"] == [(100.0, 120.0), (1100.0, 1120.0)]
    assert got["star"] == {"device_us": 8.0, "ops": 2,
                           "windows": [(121.0, 125.0), (1121.0, 1125.0)],
                           "kernels": {"star_walk": [8.0, 2]},
                           "unmatched": 0}
    outside = profiling.stage_device_time(
        [_Ev("urf::k::gather_pack", False, 0, 1),
         _Ev("urf::k::gather_pack", True, 5, 6), _Ev("k", True, 5, 6)])
    assert outside["(outside)"]["kernels"] == {"gather_pack": [1.0, 1]}
    assert outside["(outside)"]["device_us"] == 0.0


def test_stage_device_time_reports_lost_events():
    """A projection the profiler lost leaves its name's ranges unpaired:
    the stage counts them as unmatched instead of silently crediting
    less."""
    ingest = _Ev("urf::ingest", False, 0, 50)
    events = [
        ingest,
        _Ev("urf::k::ingest_prep", False, 1, 2, ingest),
        _Ev("urf::k::ingest_prep", False, 3, 4, ingest),
        _Ev("urf::k::ingest_prep", True, 100, 103),  # the second one lost
        _Ev("urf::ingest", True, 104, 110),
        _Ev("ingest_prep_kernel", True, 100, 103),
        _Ev("ingest_prep_kernel", True, 111, 114),
    ]
    got = profiling.stage_device_time(events)
    assert got["ingest"]["unmatched"] == 2
    assert got["ingest"]["kernels"] == {"ingest_prep": [0.0, 2]}
    whole = profiling.stage_device_time(
        events[:3] + [_Ev("urf::k::ingest_prep", True, 111, 114)]
        + events[3:])
    assert whole["ingest"]["unmatched"] == 0
    assert whole["ingest"]["kernels"] == {"ingest_prep": [6.0, 2]}


def test_credit_ops_to_their_ranges():
    """profiling.credit: each device op goes to the range its start lies
    in; ops outside every range go nowhere."""
    ranges = [(10.0, 20.0, "ingest"), (0.0, 5.0, "pre"), (20.0, 30.0, "star"),
              (40.0, 50.0, "ingest")]
    ops = [(1.0, 2.0), (10.0, 12.5), (19.0, 20.0), (20.0, 29.0), (35.0, 36.0),
           (41.0, 42.0), (6.0, 7.0)]
    got = profiling.credit(ops, ranges)
    assert got == {"pre": [1.0, 1], "ingest": [4.5, 3], "star": [9.0, 1]}
    rng = np.random.default_rng(0)
    edges = np.sort(rng.uniform(0, 100, 50))
    ranges = [(float(a), float(b), f"r{k}")
              for k, (a, b) in enumerate(zip(edges[::2], edges[1::2]))]
    ops = [(float(s), float(s) + 0.1) for s in rng.uniform(0, 100, 200)]
    want = {}
    for s, e in ops:
        for a, b, name in ranges:
            if a <= s < b:
                acc = want.setdefault(name, [0.0, 0])
                acc[0] += e - s
                acc[1] += 1
    got = profiling.credit(ops, ranges)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name][1] == want[name][1]
        assert got[name][0] == pytest.approx(want[name][0])
