"""The readers of what the program records of itself (program_trace.py):
the entries' host ranges on a synthetic trace, and the replay record's
stage and replay times on a synthetic record, the SP run's stage names
mapped; values worked by hand."""

from __future__ import annotations

import pytest

from benchmark import devtrace, harness, program_trace
from urban_road_filter_torch.utils import profiling

# Two calls of a compiled entry (us): the entry's range, its four child
# ranges, and host events inside them that are not children (the copy's
# runtime call, an allocation in the clones, a stage range in the launch).
HOST = [
    (0, 100, "urf::entry.packed"), (5, 10, "urf::stage_read"),
    (10, 40, "urf::copy_in"), (12, 38, "cudaMemcpyAsync"),
    (45, 60, "urf::launch"), (46, 50, "urf::ingest"),
    (60, 80, "urf::clone"), (62, 64, "aten::empty_strided"),
    (0, 105, "bench::call"),
    (200, 260, "urf::entry.packed"), (202, 204, "urf::stage_read"),
    (204, 224, "urf::copy_in"), (225, 235, "urf::launch"),
    (236, 250, "urf::clone"),
]
DEVICE = [(40, 45, "Memcpy HtoD (Pageable -> Device)", "memcpy"),
          (60, 90, "void at::native::vectorized_elementwise_kernel<4>(int)",
           "glue")]

PACKED = {"packed": {"calls": 3, "timed": 2, "untimed": 0, "replay_ms": 1.0,
                     "stage_ms": {"ingest": 0.2, "star": 0.04,
                                  "tensorize": 0.3, "xz_zero": 0.02,
                                  "blind_spots": 0.1, "markers": 0.06,
                                  "gather": 0.08}}}
SP = {"sp": {"calls": 4, "timed": 4, "untimed": 0, "replay_ms": 4.0,
             "stage_ms": {"sp_partition": 0.4, "sp_rings": 0.2,
                          "sp_star": 0.08, "sp_tensorize": 0.8,
                          "sp_xz_zero": 0.4, "sp_blind_spots": 1.2,
                          "sp_markers": 0.16, "sp_gather": 0.24}}}
BATCH = {"batch": {"calls": 2, "timed": 2, "untimed": 0, "replay_ms": 12.8,
                   "stage_ms": {"ingest": 2.56}}}


class Ctx:
    def __init__(self, trace, per_call=1):
        self.trace = trace
        self.scans_per_call = per_call


def _trace(per_call=1, host=HOST):
    return devtrace.Trace(DEVICE, host, window_s=1e-3, scans=2 * per_call)


@pytest.fixture
def record(monkeypatch):
    """Make the program's record read as the dict put in ``box[0]``,
    counting the flushes."""
    box, flushes = [{}], []
    monkeypatch.setattr(profiling, "replay_record", lambda: box[0])
    monkeypatch.setattr(profiling, "flush", lambda: flushes.append(1))
    return box, flushes


# Per scan over 2 scans: copy-in (30 + 20) / 2 us, launch (15 + 10) / 2,
# clones (20 + 14) / 2; the entry's self time (100 - 70 + 60 - 46) / 2.
@pytest.mark.parametrize("metric,want", [
    ("copy_in_ms.scan", 0.025), ("launch_ms.scan", 0.0125),
    ("clone_ms.scan", 0.017), ("entry_self_ms.scan", 0.022)])
def test_entry_ranges(metric, want):
    got = harness.metric_reader(metric)(Ctx(_trace()))
    assert got == pytest.approx(want, rel=1e-9)


def test_entry_self_time_takes_the_union_of_its_children():
    """Overlapping child ranges count once; a child reaching past the
    entry counts only inside it."""
    host = [(0, 100, "urf::entry.sp"), (10, 50, "urf::copy_in"),
            (30, 60, "urf::launch"), (90, 120, "urf::clone")]
    got = program_trace.entry_self_ms(Ctx(_trace(host=host)))
    assert got == pytest.approx((100 - 50 - 10) / 2 / 1e3, rel=1e-9)


@pytest.mark.parametrize("stage,want", [
    ("ingest", 0.1), ("star", 0.02), ("tensorize", 0.15), ("xz_zero", 0.01),
    ("blind_spots", 0.05), ("markers", 0.03), ("gather", 0.04)])
def test_stage_readers_on_the_record(record, stage, want):
    box, flushes = record
    box[0] = PACKED
    got = harness.metric_reader(f"{stage}_ms.scan")(Ctx(_trace()))
    assert got == pytest.approx(want, rel=1e-9)
    assert flushes
    assert harness.metric_reader("replay_ms.scan")(Ctx(_trace())) == \
        pytest.approx(0.5, rel=1e-9)


@pytest.mark.parametrize("stage,want", [
    ("ingest", (0.4 + 0.2) / 4), ("star", 0.02), ("tensorize", 0.2),
    ("xz_zero", 0.1), ("blind_spots", 0.3), ("markers", 0.04),
    ("gather", 0.06)])
def test_sp_stages_map_onto_the_scan_stages(record, stage, want):
    box, _ = record
    box[0] = SP
    got = harness.metric_reader(f"{stage}_ms.scan")(Ctx(_trace()))
    assert got == pytest.approx(want, rel=1e-9)
    assert program_trace.replay_ms(Ctx(_trace())) == pytest.approx(1.0)


def test_batch_replay_per_scan(record):
    box, _ = record
    box[0] = BATCH
    ctx = Ctx(_trace(per_call=128), per_call=128)
    assert harness.metric_reader("replay_ms.batch")(ctx) == pytest.approx(
        12.8 / (2 * 128), rel=1e-9)
    assert program_trace.stage_ms(ctx, "ingest") == pytest.approx(0.01)


def test_nothing_timed_or_no_stage_reads_none(record):
    box, _ = record
    box[0] = {"packed": dict(PACKED["packed"], timed=0, untimed=2)}
    assert program_trace.replay_ms(Ctx(_trace())) is None
    box[0] = {"packed": dict(PACKED["packed"], stage_ms={"ingest": 0.2})}
    assert program_trace.stage_ms(Ctx(_trace()), "star") is None
    assert program_trace.stage_ms(Ctx(_trace()), "ingest") == \
        pytest.approx(0.1)


@pytest.mark.parametrize("metric", [
    "ingest_ms.scan", "replay_ms.scan", "replay_ms.batch", "copy_in_ms.scan",
    "entry_self_ms.scan"])
def test_a_program_without_the_record_or_ranges_reads_none(monkeypatch,
                                                           metric):
    """A tree whose program keeps no replay record and opens no entry
    ranges: every reader gives None, none raises."""
    monkeypatch.delattr(profiling, "replay_record")
    monkeypatch.delattr(profiling, "flush")
    host = [(0, 100, "bench::call"), (10, 40, "cudaMemcpyAsync")]
    assert harness.metric_reader(metric)(Ctx(_trace(host=host))) is None


NEW = ("ingest_ms.scan", "star_ms.scan", "tensorize_ms.scan",
       "xz_zero_ms.scan", "blind_spots_ms.scan", "markers_ms.scan",
       "gather_ms.scan", "replay_ms.scan", "replay_ms.batch",
       "copy_in_ms.scan", "launch_ms.scan", "clone_ms.scan",
       "entry_self_ms.scan")


def test_every_per_layer_metric_has_a_synthetic_reading():
    """Each per-layer metric is worked by hand either in
    test_bench_metrics.EXPECTED or here."""
    from benchmark.tests import test_bench_metrics as tbm

    names = {m["name"] for m in harness.benchmark_file()["per_layer"]}
    assert set(NEW) <= names
    assert {n for n in names if n.split(".")[0] not in tbm.EXPECTED} == \
        set(NEW)


@pytest.mark.parametrize("metric", NEW)
def test_reader_on_the_device_only_synthetic_trace(record, metric):
    """On test_bench_metrics' trace (device rows and the harness's host
    ranges, none of the program's) and an empty record: None."""
    from benchmark.tests import test_bench_metrics as tbm

    tr = devtrace.Trace(tbm.DEVICE, tbm.HOST, window_s=1e-3, scans=10)
    assert harness.metric_reader(metric)(tbm.Ctx(tr)) is None
