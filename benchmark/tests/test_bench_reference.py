"""The yardstick's frozen copies against the port's originals, the whole
run on the CPU at a tiny size (the port's plain twins against the frozen
reference), the faults that each cell can have, and the control."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import check, harness, reference, scans
from benchmark.calibrate import control_readings
from benchmark.tests.tiny import CELLS, tiny_cell

SEED = 2**31 + 977


def test_drive_copy_gives_the_originals_bytes():
    from urban_road_filter_torch.io import make_drive

    for sensor in ("os1_64", "os1_128"):
        mine = list(scans.make_drive(2, sensor=sensor, seed=SEED,
                                     firings=96))
        theirs = list(make_drive(2, sensor=sensor, seed=SEED, firings=96))
        for a, b in zip(mine, theirs):
            assert a.tobytes() == b.tobytes()


def test_pool_is_the_seeds_drive_azimuth_sorted():
    from urban_road_filter_torch.parallel.azimuth_parallel import (
        azimuth_sorted)

    traffic = {"pool": 3, "speed_mps": 8.0, "rate_hz": 10.0}
    pool = scans.make_pool(traffic, "os1_64", 96, SEED)
    again = scans.make_pool(traffic, "os1_64", 96, SEED, threads=1)
    drive = list(scans.make_drive(3, sensor="os1_64", seed=SEED,
                                  firings=96))
    for p, q, d in zip(pool, again, drive):
        assert p.tobytes() == q.tobytes() == azimuth_sorted(d).tobytes()
    other = scans.make_pool(traffic, "os1_64", 96, SEED + 1)
    assert other[0].tobytes() != pool[0].tobytes()


def test_reference_copy_gives_the_oracles_result():
    from urban_road_filter_torch.config import FilterConfig
    from urban_road_filter_torch.oracle import run_oracle

    cell = harness.Cell("os1-128.scan")
    rows = scans.make_pool({"pool": 1, "speed_mps": 8.0, "rate_hz": 10.0},
                           "os1_128", 128, SEED)[0]
    settings = reference.filter_settings(cell.config["filter"])
    mine = reference.run_oracle(rows, settings, channels=128)
    theirs = run_oracle(rows, FilterConfig(**cell.config["filter"]),
                        channels=128)
    for field in ("roi_mask", "labels", "ring_of_point", "marker_points",
                  "marker_bins", "probably_road_ids", "max_distance"):
        assert np.array_equal(getattr(mine, field), getattr(theirs, field))
    assert (mine.ok, mine.num_rings) == (theirs.ok, theirs.num_rings)
    assert mine.num_rings > 30 and mine.labels.size > 1000


@pytest.mark.parametrize("cell", CELLS)
def test_run_on_cpu_is_correct(cell):
    """The port's plain twins through the cell's own driver and entry, at
    a tiny size, against the frozen reference: every number 0."""
    line, lines = harness.run_cell(tiny_cell(cell), SEED, 0.5, False,
                                   device="cpu")
    assert line["correct"], lines
    assert all(v["value"] == 0 for v in line["checks"].values())
    assert list(line)[-1] == "checks"
    assert line["attempted"] >= 1 and line["failed"] == 0
    e2e = {m["name"] for m in harness.Cell(cell).end_to_end}
    assert set(line["metrics"]) == e2e


def _shifted(t):
    """Each point's answer written into its neighbour's slot."""
    return torch.roll(t, 1, dims=-1)


def fault_answer(monkeypatch):
    """A wrong answer where it is produced: the output stage writes each
    point's label, ROI bit and probably_road bit one point over (the
    packed plane too)."""
    from urban_road_filter_torch import pipeline

    real, real_batch = pipeline.gather_pack, pipeline.gather_pack_batch

    def gp(*a, **k):
        return tuple(_shifted(t) for t in real(*a, **k))

    def gpb(*a, **k):
        return tuple(_shifted(t) for t in real_batch(*a, **k))

    monkeypatch.setattr(pipeline, "gather_pack", gp)
    monkeypatch.setattr(pipeline, "gather_pack_batch", gpb)

    from urban_road_filter_torch.parallel import azimuth_parallel as ap
    real_run = ap._run

    def run(*a, **k):
        res = real_run(*a, **k)
        return res._replace(labels=_shifted(res.labels),
                            roi=_shifted(res.roi),
                            probably_road=_shifted(res.probably_road))

    monkeypatch.setattr(ap, "_run", run)


def fault_half_batch(monkeypatch):
    """Half of the batch left out: the entry computes the first half of
    its lanes and hands their outputs out for the second half too."""
    from urban_road_filter_torch import pipeline

    real = pipeline._batch_on

    def half(pts, cfg, dims, layout, probe=None):
        b = pts.shape[0]
        res = real(pts[: b // 2], cfg, dims, layout, probe)
        return res._make(torch.cat([t, t]) if t.dim() else t for t in res)

    monkeypatch.setitem(pipeline._BODIES, "batch", half)


FAULTS = [(c, "answer") for c in CELLS] + [
    ("os1-64.replay-b128", "half_batch")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_makes_the_run_incorrect(cell, fault, monkeypatch):
    """The whole run, with the timed path broken underneath: correct
    comes out false."""
    from urban_road_filter_torch import pipeline

    monkeypatch.setattr(pipeline, "_compiled", {})
    {"answer": fault_answer, "half_batch": fault_half_batch}[fault](
        monkeypatch)
    line, lines = harness.run_cell(tiny_cell(cell, firings=256, sample=4),
                                   SEED, 0.5, False, device="cpu")
    assert not line["correct"], lines
    assert line["failed"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_incorrect(cell):
    """The control (the reference on rows rounded to bfloat16 in the
    program's place) fails the cell's limits."""
    tiny = tiny_cell(cell, firings=256, pool=2)
    worst = control_readings(tiny, SEED)
    limits = harness.Cell(cell).workload["limits"]
    assert any(worst[k] > limits[k] for k in check.NUMBERS), worst


def test_bf16_rows_rounds_to_nearest_even():
    rows = np.array([[1.0, 1.00390625, 1.005859375, 7.0],
                     [0.0, 0.0, 0.0, 0.5]], np.float32)
    out = check.bf16_rows(rows)
    assert out[0, :3].tolist() == [1.0, 1.0, 1.0078125]
    assert out[0, 3] == 7.0 and out[1].tolist() == [0.0, 0.0, 0.0, 0.5]
