"""The port's profiling hooks (urban_road_filter_torch.utils.profiling) on
the CPU: device_trace writing a Chrome trace that holds the pipeline's
urf::<stage> ranges and span's, the launch wrapper's profiler test
(_build._profiling) true only inside a trace, stage_device_time's
crediting of device ops, the port's kernels included, to the stage
windows that hold them (tools/profile_torch_scan.py reads it); the
compiled entries' ranges under a profiler (urf::entry.<kind> around the
call, the body's run in urf::launch, the stages inside it, one call
number a call), none entered and nothing recorded without one; the
replay record on fake events (sums by stage, an incomplete replay untimed
without a wait, flush) and a traced call's order on a fake graph (the
traced variant captured once, apart from CAPTURE_COUNTS, each replay read
at the next call).  On the card, chip_smoke.py phase 7 holds each kernel
launch inside its stage's range, and tests/test_torch_kernels_gpu.py the
traced variants against the plain graphs."""

import glob
import json

import numpy as np
import pytest
import torch

from urban_road_filter_torch import (
    FilterConfig, PipelineDims, _build, pad_scan, packed_scan_jit,
    process_batch_jit, process_scan)
from urban_road_filter_torch import pipeline as pl
from urban_road_filter_torch.io import SCENES, make_scan
from urban_road_filter_torch.parallel.azimuth_parallel import (
    azimuth_sorted, make_azimuth_pipeline)
from urban_road_filter_torch.utils import profiling

torch.set_num_threads(1)  # tier-1 runs several pytest workers

DIMS = PipelineDims(max_points=4096, rings=64, ring_capacity=512,
                    beam_capacity=128)
STAGES = ("ingest", "star", "tensorize", "xz_zero", "blind_spots",
          "markers", "gather")


def test_device_trace_writes_the_stage_ranges(tmp_path):
    pts = torch.from_numpy(pad_scan(make_scan(
        SCENES["two_curbs"](), n_rings=16, n_azimuth=192, seed=3),
        DIMS.max_points))
    assert not _build._profiling()
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        assert _build._profiling()
        with profiling.span("urf::demo_block"):
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


# --- the compiled entries' ranges and the replay record ---

SP_STAGES = ("sp_partition", "sp_rings", "sp_star", "sp_tensorize",
             "sp_xz_zero", "sp_blind_spots", "sp_markers", "sp_gather")


def _scan(seed=3):
    return make_scan(SCENES["two_curbs"](), n_rings=16, n_azimuth=192,
                     seed=seed)


def _entries():
    """{kind: a call of that compiled entry on the CPU, and the stages its
    body runs}."""
    cfg = FilterConfig()
    rows = pad_scan(_scan(), DIMS.max_points)
    batch = np.stack([rows, pad_scan(_scan(4), DIMS.max_points)])
    sp_rows = pad_scan(azimuth_sorted(_scan()), DIMS.max_points)
    run = make_azimuth_pipeline(8, cfg, DIMS, device="cpu")
    return {
        "packed": (lambda: packed_scan_jit(rows, cfg, DIMS, device="cpu"),
                   STAGES),
        "batch": (lambda: process_batch_jit(batch, cfg, DIMS, device="cpu"),
                  STAGES),
        "sp": (lambda: run(sp_rows), SP_STAGES)}


@pytest.fixture
def spans(monkeypatch):
    """[(name, args)] of every range the port opens, in order, the real
    ranges still opened."""
    seen = []
    real = profiling.record_function

    def spy(name, args=None):
        seen.append((name, args))
        return real(name, args)

    monkeypatch.setattr(profiling, "record_function", spy)
    return seen


@pytest.mark.parametrize("kind", ["packed", "batch", "sp"])
def test_entry_ranges_nest_and_carry_the_call_number(kind, spans):
    """Under a profiler a compiled entry's call is one urf::entry.<kind>
    range (no urf:: range around it), the body's run a urf::launch inside
    it (on the CPU it stands for the replay), each stage inside that; the
    entry and its launch carry the call's number, a new one each call."""
    call, stages = _entries()[kind]
    call()  # the entry made, untraced
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
        call()
    entry = f"urf::entry.{kind}"
    got = [e for e in prof.events() if e.name.startswith("urf::")
           and not e.name.startswith("urf::k::")]
    parent = {e.name: set() for e in got}
    for e in got:
        parent[e.name].add(e.cpu_parent.name if e.cpu_parent else None)
    assert parent[entry] == {None}
    assert parent["urf::launch"] == {entry}
    for stage in stages:
        assert parent[f"urf::{stage}"] == {"urf::launch"}, stage
    assert set(parent) == {entry, "urf::launch",
                           *(f"urf::{s}" for s in stages)}
    calls = [a for n, a in spans if n == entry]
    assert len(calls) == 2 and calls[1] == str(int(calls[0]) + 1)
    assert [a for n, a in spans if n == "urf::launch"] == calls
    assert profiling.replay_record()[kind]["timed"] == 0


def test_no_profiler_no_ranges_and_no_record(monkeypatch):
    """Without a profiler the compiled entries (and the stages of their
    bodies) enter no record_function, and the replay record does not
    move."""
    entries = _entries()
    for call, _ in entries.values():
        call()
    before = profiling.replay_record()
    opened = []

    def counted(*args, **kw):
        opened.append(args)
        raise AssertionError("a range was opened")

    for mod in (profiling, torch.profiler, torch.autograd.profiler):
        monkeypatch.setattr(mod, "record_function", counted)
    for call, _ in entries.values():
        call()
    assert opened == []
    assert profiling.replay_record() == before


class _Event:
    """A timing event: a time on a fake clock; ``replay`` ({"done",
    "waited"}) is shared by the events of one replay, which complete
    together, as a stream runs them in order."""

    clock = [0.0]

    def __init__(self, t=None, replay=None):
        if t is None:
            _Event.clock[0] += 1.5
            t = _Event.clock[0]
        self.t = t
        self.replay = {"done": True, "waited": 0} if replay is None else replay

    def query(self):
        return self.replay["done"]

    def synchronize(self):
        self.replay["waited"] += 1
        self.replay["done"] = True

    def elapsed_time(self, other):
        assert self.replay["done"] and other.replay["done"]
        return other.t - self.t


def _events(kind, stages, done=True):
    replay = {"done": done, "waited": 0}
    ev = profiling.StageEvents(kind, _Event(0.0, replay))
    t = 0.0
    for name, ms in stages:
        ev.stages.append((name, _Event(t + 0.1, replay),
                          _Event(t + 0.1 + ms, replay)))
        t += 0.1 + ms
    ev.last = _Event(t + 0.2, replay)
    return ev


def test_record_sums_by_stage():
    rec = profiling.ReplayRecord()
    a = _events("packed", [("ingest", 0.5), ("star", 0.25)])
    b = _events("sp", [("sp_partition", 1.0), ("sp_star", 0.5),
                       ("sp_star", 0.25)])
    for ev in (a, b, a):
        rec.replayed(ev)
        rec.settle(ev)
    got = rec.totals()
    assert got["packed"]["timed"] == 2 and got["packed"]["untimed"] == 0
    assert got["packed"]["stage_ms"] == pytest.approx(
        {"ingest": 1.0, "star": 0.5})
    assert got["packed"]["replay_ms"] == pytest.approx(2 * (0.95 + 0.2))
    assert got["sp"]["stage_ms"] == pytest.approx({"sp_partition": 1.0,
                                                   "sp_star": 0.75})
    assert got["sp"]["replay_ms"] == pytest.approx(2.05 + 0.2)
    assert rec.pending == []
    rec.settle(a)  # nothing pending: nothing read
    assert rec.totals() == got


def test_record_counts_an_incomplete_replay_untimed_without_waiting():
    rec = profiling.ReplayRecord()
    ev = _events("batch", [("ingest", 1.0)], done=False)
    rec.replayed(ev)
    rec.settle(ev)
    assert ev.last.replay["waited"] == 0
    got = rec.totals()["batch"]
    assert (got["timed"], got["untimed"], got["stage_ms"]) == (0, 1, {})
    assert rec.pending == []


def test_flush_reads_the_pending_replays():
    rec = profiling.ReplayRecord()
    done = _events("packed", [("gather", 0.5)])
    running = _events("sp", [("sp_gather", 0.25)], done=False)
    rec.replayed(done)
    rec.replayed(running)
    assert rec.totals() == {}
    rec.flush()
    assert running.last.replay["waited"] == 1 and rec.pending == []
    got = rec.totals()
    assert got["packed"]["timed"] == got["sp"]["timed"] == 1
    assert got["sp"]["stage_ms"] == pytest.approx({"sp_gather": 0.25})
    assert got["sp"]["untimed"] == 0


class _Graph:
    """A captured graph: replay() counts."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_traced_call_on_a_fake_graph(monkeypatch, spans):
    """The card's traced path with the graph faked on the CPU: the first
    traced call captures the traced variant once (its body run under
    timed_capture, each stage given its events; TRACED_CAPTURES moves,
    CAPTURE_COUNTS not), every traced call replays it between its
    stage_read, copy_in, launch and clone ranges, each replay is read at
    the next call and the last by flush; untraced calls replay the plain
    graph and open nothing."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(profiling, "_event", lambda: _Event())
    monkeypatch.setattr(profiling, "RECORD", profiling.ReplayRecord())
    monkeypatch.setattr(_build, "replayed", lambda *a: None)
    cfg = FilterConfig()
    rows = torch.from_numpy(pad_scan(_scan(), DIMS.max_points))
    st, dyn = pl.split_cached(cfg)
    entry = pl._Compiled("packed", pl._BODIES["packed"], st, dyn, DIMS,
                         "rows", rows)
    plain = _Graph()
    entry.graph, entry.input, entry.launches, entry.ticketed = (
        plain, torch.empty_like(rows), {}, [])
    entry.out = pl._packed_outputs(entry.input, entry.cfg, DIMS, "rows")
    traced = _Graph()

    def graph(around):
        with around as events:
            out = entry.body(entry.input, entry.cfg, DIMS, "rows")
        return traced, out, {}, events, {"nodes": {}}

    monkeypatch.setattr(entry, "_graph", graph)
    captures, before = dict(pl.CAPTURE_COUNTS), dict(pl.TRACED_CAPTURES)
    entry(rows, dyn)
    assert plain.replays == 1 and entry.traced is None and spans == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(3):
            call = profiling.entry_call("packed")
            with profiling.entry_span("packed", call):
                out = entry(rows, dyn, call)
            assert [t.shape for t in out] == [t.shape for t in entry.out]
            assert traced.replays == k + 1
            assert profiling.replay_record()["packed"]["timed"] == k
    assert plain.replays == 1
    assert pl.CAPTURE_COUNTS == captures
    assert pl.TRACED_CAPTURES["packed"] == before["packed"] + 1
    _, _, events = entry.traced
    assert [n for n, _, _ in events.stages] == list(STAGES)
    profiling.flush()
    got = profiling.replay_record()["packed"]
    assert (got["calls"], got["timed"], got["untimed"]) == (3, 3, 0)
    assert set(got["stage_ms"]) == set(STAGES)
    assert sum(got["stage_ms"].values()) < got["replay_ms"]
    children = ("urf::stage_read", "urf::copy_in", "urf::launch",
                "urf::clone")
    parents = {e.name: e.cpu_parent and e.cpu_parent.name
               for e in prof.events() if e.name in children}
    assert parents == dict.fromkeys(children, "urf::entry.packed")
    order = [n for n, _ in spans if n in children]
    assert order == list(children) * 3
    assert {a for n, a in spans if n in children} == {"1", "2", "3"}
    entry(rows, dyn)
    assert plain.replays == 2 and traced.replays == 3
