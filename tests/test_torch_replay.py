"""The port's replay harness (urban_road_filter_torch.io.replay), on the CPU
(``device="cpu"``: the kernels' plain twins), at small dims.

* Against the JAX ``ReplayHarness`` on the same ``scene_source`` scans: the
  five topics and the marker strips, exact or classified.  The ROI cloud
  must be equal; labels and markers exact or classified as in
  tests/test_torch_pipeline.py (a flip within 1e-4 degrees of a bin edge,
  or inside the oracle's ulp envelope); where the labels are equal, the
  road and curb clouds are equal bit for bit, and where the marker tables
  are equal, so are the strips.
* The semantics of tests/test_io_runtime.py's TestReplay and
  TestReplayPipelined: drops that never stage, checkpoint resume and
  invalidation, malformed scans mid-stream and trailing, truncation past
  max_points, depth 2 equal to depth 1, the latency invariant.
* SP mode through the harness equals the port's own SP run, topic for
  topic (the JAX harness cannot unpack an SP scan: it tests
  ``isinstance(out, tuple)``, which a ScanResult passes), and
  ``_fetch_outputs`` dispatches on the concrete type.
* Defaults: no device means the card (raises without one).  Checked mode
  publishes the default topics on clean scans and refuses (records as
  that scan's error) a scan that breaks an index contract.  The CLI
  replays the PCD fixtures, also with --checked; viz draws the port's
  ScanOutputs.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from test_torch_pipeline import (
    _assert_labels_vs_jax, _assert_markers_vs_jax, _envelope)
from urban_road_filter_tpu.config import PipelineDims as JaxDims
from urban_road_filter_tpu.io.replay import ReplayHarness as JaxHarness
from urban_road_filter_tpu.io.replay import scene_source as jax_scenes
from urban_road_filter_tpu.oracle import run_oracle
from urban_road_filter_torch import (
    FilterConfig, PipelineDims, ScanResult, packed_scan, pad_scan_planar,
    process_scan)
from urban_road_filter_torch.io import SCENES, make_scan
from urban_road_filter_torch.io import replay as replay_mod
from urban_road_filter_torch.io.replay import (
    ReplayHarness, ScanOutputs, scene_source)
from urban_road_filter_torch.parallel.azimuth_parallel import (
    azimuth_sorted, make_azimuth_pipeline)

torch.set_num_threads(1)  # tier-1 runs several pytest workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = PipelineDims(max_points=8192, rings=64, ring_capacity=1024,
                    beam_capacity=256)
CPU = dict(dims=DIMS, device="cpu")


def _flat(n=1, seed=0):
    return [make_scan(SCENES["flat"](), n_rings=16, n_azimuth=256,
                      seed=seed + i) for i in range(n)]


class _Recording:
    """Keeps every scan's fetched host outputs beside its topics."""

    def _postprocess(self, raw, host_out, *args, **kw):
        out = super()._postprocess(raw, host_out, *args, **kw)
        self.fetched.append((raw, host_out, out))
        return out


class PortRecording(_Recording, ReplayHarness):
    pass


class JaxRecording(_Recording, JaxHarness):
    pass


def _scans():
    return (list(jax_scenes("two_curbs", n_scans=2, n_rings=16,
                            n_azimuth=256))
            + list(jax_scenes("curb_gap", n_scans=2, n_rings=16,
                              n_azimuth=384)))


@pytest.fixture(scope="module")
def both_runs():
    """The port's and the JAX harness's runs over the same scans (one JAX
    run per module: it compiles)."""
    scans = _scans()
    port = PortRecording(**CPU)
    port.fetched = []
    port.run(iter(scans))
    jax = JaxRecording(dims=JaxDims(**DIMS.__dict__))
    jax.fetched = []
    jax.run(iter(scans))
    return scans, port.fetched, jax.fetched


def _same_cloud(a, b):
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_port_scene_source_equals_jax():
    for a, b in zip(scene_source("curb_gap", n_scans=2, n_rings=16,
                                 n_azimuth=384),
                    jax_scenes("curb_gap", n_scans=2, n_rings=16,
                               n_azimuth=384)):
        _same_cloud(a, b)


def test_harness_against_jax(both_runs):
    from urban_road_filter_tpu.config import FilterConfig as JaxConfig

    scans, port, jax = both_runs
    assert len(port) == len(jax) == len(scans)
    tables_equal = True
    for k, (pts, (raw, p_host, p_out), (_, j_host, j_out)) in enumerate(
            zip(scans, port, jax)):
        assert p_out.seq == j_out.seq == k and p_out.ok and j_out.ok
        _same_cloud(p_out.roi, j_out.roi)
        _same_cloud(p_out.road_probably, j_out.road_probably)
        orc = run_oracle(pts, JaxConfig())
        env = _envelope(pts, JaxConfig())
        p_lab, j_lab = np.asarray(p_host[0]), np.asarray(j_host[0])
        _assert_labels_vs_jax(p_lab.astype(np.int8), j_lab.astype(np.int8),
                              pts, orc.roi_mask, orc, env, f"scan {k}")
        _assert_markers_vs_jax(p_host[3], np.asarray(j_host[3]), orc, env,
                               f"scan {k} markers")
        if np.array_equal(p_lab, j_lab):
            _same_cloud(p_out.road, j_out.road)
            _same_cloud(p_out.curb, j_out.curb)
        tables_equal &= np.array_equal(np.asarray(p_host[3]).view(np.int32),
                                       np.asarray(j_host[3]).view(np.int32))
        if tables_equal:  # the trackers have seen the same strips
            assert len(p_out.marker_strips) == len(j_out.marker_strips) > 0
            for a, b in zip(p_out.marker_strips, j_out.marker_strips):
                assert (a.id, a.color) == (b.id, b.color)
                _same_cloud(a.points, b.points)
        for f in ("points_in", "points_roi", "num_rings", "overflow"):
            assert getattr(p_out.stats, f) == getattr(j_out.stats, f), f


def test_stream_runs_and_reports():
    h = ReplayHarness(**CPU)
    m = h.run(scene_source("two_curbs", n_scans=3, n_rings=16,
                           n_azimuth=256), max_scans=3)
    s = m.summary()
    assert s["scans"] == 3 and s["not_ok"] == 0 and s["errors"] == 0
    assert s["latency_ms"]["p50"] > 0
    assert h.device.type == "cpu"


def test_dropped_scans_never_staged(monkeypatch):
    """Queue-1 drops are free: a dropped scan is consumed raw, never padded
    or copied (lidar_segmentation.cpp:53)."""
    h = ReplayHarness(rate_hz=1000.0, drop_when_behind=True, **CPU)
    staged = []
    orig = ReplayHarness._to_device

    def counting(self, raw):
        staged.append(1)
        time.sleep(0.01)  # 10 ms per scan >> the 1 ms period: must lag
        return orig(self, raw)

    monkeypatch.setattr(ReplayHarness, "_to_device", counting)
    m = h.run(iter(_flat(40)))
    s = m.summary()
    assert s["dropped"] > 0, s
    assert s["scans"] + s["dropped"] + s["errors"] == 40
    assert len(staged) <= s["scans"] + 1, (len(staged), s)
    assert h._seq == 40


@pytest.mark.parametrize("depth", [1, 2])
def test_checkpoint_resume(depth, tmp_path):
    ck = str(tmp_path / "ck.json")
    scans = _flat(5)
    ReplayHarness(checkpoint_path=ck, pipeline_depth=depth, **CPU).run(
        iter(scans), max_scans=2)
    assert json.load(open(ck))["seq"] == 2
    seen = []
    ReplayHarness(checkpoint_path=ck, pipeline_depth=depth,
                  on_scan=lambda o: seen.append(o.seq), **CPU).run(
        iter(scans))
    assert seen == [2, 3, 4]  # resumed mid-stream, no scan twice


def test_checkpoint_invalidated_by_config_change(tmp_path):
    ck = str(tmp_path / "ck.json")
    scans = _flat(3)
    ReplayHarness(checkpoint_path=ck, **CPU).run(iter(scans), max_scans=1)
    seen = []
    ReplayHarness(cfg=FilterConfig(beam_zone=50.0), checkpoint_path=ck,
                  on_scan=lambda o: seen.append(o.seq), **CPU).run(
        iter(scans), max_scans=1)
    assert seen == [0]  # config hash mismatch: the stream restarts


def test_scan_larger_than_capacity_truncates():
    big = make_scan(SCENES["flat"](), n_rings=24, n_azimuth=384, seed=3)
    assert len(big) > DIMS.max_points
    got = []
    ReplayHarness(on_scan=got.append, **CPU).run(iter([big]))
    o = got[0]
    assert o.ok and o.stats.points_in == DIMS.max_points
    assert len(o.roi) <= DIMS.max_points


@pytest.mark.parametrize("depth", [1, 2])
def test_malformed_scans_isolated(depth):
    good = _flat(1)[0]
    bad = np.zeros((100,), np.float32)  # 1-D: cannot be padded
    got = []
    h = ReplayHarness(on_scan=got.append, pipeline_depth=depth, **CPU)
    m = h.run(iter([good, bad, good, bad]))
    s = m.summary()
    assert s["scans"] == 2 and s["errors"] == 2
    assert [o.seq for o in got] == [0, 2]  # an errored scan takes a seq
    assert "stage:" in m.last_error
    assert h._seq == 4  # the trailing malformed scan charged at the end


def test_trailing_malformed_scans_charged_to_checkpoint(tmp_path):
    ck = str(tmp_path / "ck.json")
    bad = np.zeros((100,), np.float32)
    m = ReplayHarness(checkpoint_path=ck, **CPU).run(
        iter([_flat(1)[0], bad, bad]))
    assert m.summary()["scans"] == 1 and m.summary()["errors"] == 2
    assert json.load(open(ck))["seq"] == 3


def test_depth2_equals_depth1_and_latency_invariant():
    scans = [make_scan(SCENES["two_curbs" if i % 2 else "curb_gap"](),
                       n_rings=16, n_azimuth=256, seed=i) for i in range(4)]
    runs = {}
    for depth in (1, 2, 3):
        got = []
        m = ReplayHarness(on_scan=got.append, pipeline_depth=depth,
                          **CPU).run(iter(scans))
        assert m.summary()["errors"] == 0
        runs[depth] = got
    for depth in (2, 3):
        assert [o.seq for o in runs[depth]] == [o.seq for o in runs[1]]
        for a, b in zip(runs[depth], runs[1]):
            assert a.ok == b.ok
            for f in ("road", "curb", "roi", "road_probably"):
                _same_cloud(getattr(a, f), getattr(b, f))
            assert [(s.id, s.color) for s in a.marker_strips] == [
                (s.id, s.color) for s in b.marker_strips]
            assert a.stats.marker_count == b.stats.marker_count
    for o in runs[3]:
        st = o.stats
        assert st.stage_ms == 0.0
        np.testing.assert_allclose(st.dispatch_ms + st.fetch_ms,
                                   st.latency_ms, rtol=1e-6)


def test_drops_engage_at_depth2(monkeypatch):
    h = ReplayHarness(rate_hz=1000.0, drop_when_behind=True,
                      pipeline_depth=2, **CPU)
    orig = ReplayHarness._to_device

    def slow(self, raw):
        time.sleep(0.01)
        return orig(self, raw)

    monkeypatch.setattr(ReplayHarness, "_to_device", slow)
    s = h.run(iter(_flat(40))).summary()
    assert s["dropped"] > 0, s
    assert s["scans"] + s["dropped"] + s["errors"] == 40
    assert h._seq == 40


def test_sp_mode_equals_the_sp_run():
    """azimuth_shard=8: the harness's topics equal those built from
    make_azimuth_pipeline's own results, scan by scan."""
    cfg = FilterConfig()
    scans = [azimuth_sorted(make_scan(SCENES["two_curbs"](), n_rings=16,
                                      n_azimuth=384, seed=s))
             for s in (0, 1)]
    got = []
    m = ReplayHarness(cfg=cfg, azimuth_shard=8, on_scan=got.append,
                      **CPU).run(iter(scans))
    assert m.summary()["errors"] == 0, m.last_error
    run = make_azimuth_pipeline(8, cfg, DIMS, device="cpu")
    ref = ReplayHarness(cfg=cfg, **CPU)
    assert len(got) == 2
    for k, (scan, o) in enumerate(zip(scans, got)):
        res = run(torch.from_numpy(pad_scan_planar(scan, DIMS.max_points)),
                  layout="planar")
        ref._seq = k
        want = ref._postprocess(scan, ref._fetch_outputs(res), 0.0)
        assert o.ok and want.ok and o.seq == want.seq == k
        for f in ("road", "curb", "roi", "road_probably"):
            _same_cloud(getattr(o, f), getattr(want, f))
        assert len(o.marker_strips) == len(want.marker_strips) > 0
        for a, b in zip(o.marker_strips, want.marker_strips):
            assert (a.id, a.color) == (b.id, b.color)
            _same_cloud(a.points, b.points)


def test_fetch_outputs_dispatches_on_the_concrete_type():
    h = ReplayHarness(**CPU)
    pts = torch.from_numpy(pad_scan_planar(_flat(1)[0], DIMS.max_points))
    res = process_scan(pts, h.cfg, DIMS, layout="planar", device="cpu")
    assert isinstance(res, tuple)  # a NamedTuple: the reference's trap
    full = h._fetch_outputs(res)
    packed = h._fetch_outputs(packed_scan(pts, h.cfg, DIMS, layout="planar",
                                          device="cpu"))
    assert len(full) == len(packed) == 7
    for a, b in zip(full, packed):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert isinstance(res, ScanResult)
    with pytest.raises(TypeError):
        h._fetch_outputs(list(res))


def test_no_device_means_the_card():
    if torch.cuda.is_available():
        assert ReplayHarness().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ReplayHarness()


def test_checked_mode_refuses(monkeypatch):
    """Checked mode refuses a scan that breaks an index contract (a ring id
    past the table, which the default path masks silently): the harness
    records that scan as an error naming the contract and goes on; the
    default harness records none."""
    from urban_road_filter_torch.ops import ingest

    orig = ingest.assign_rings

    def bad(alpha, valid, angles_sorted, interval):
        ring = orig(alpha, valid, angles_sorted, interval).clone()
        ring[0, int(torch.nonzero(valid[0])[0])] = angles_sorted.shape[-1] + 3
        return ring

    monkeypatch.setattr(ingest, "assign_rings", bad)
    scans = _flat(2)
    plain = ReplayHarness(**CPU).run(iter(scans)).summary()
    assert plain["errors"] == 0 and plain["scans"] == 2
    h = ReplayHarness(checked=True, **CPU)
    m = h.run(iter(scans))
    assert m.summary()["errors"] == 2 and m.summary()["scans"] == 0
    assert "ring_id" in m.last_error and "IndexContractError" in m.last_error
    assert h._seq == 2  # both positions consumed, as for any failed scan


def test_checked_mode_equals_default():
    """On clean scans the checked harness publishes the default harness's
    topics, field for field, with no error; its (CheckError, ScanResult)
    output is fetched in one go, the error word with it."""
    scans = _flat(2) + list(scene_source("two_curbs", n_scans=1,
                                         n_rings=16, n_azimuth=256))
    runs = {}
    for checked in (False, True):
        h = PortRecording(checked=checked, **CPU)
        h.fetched = []
        assert h.run(iter(scans)).summary()["errors"] == 0
        runs[checked] = h.fetched
    for (_, a, oa), (_, b, ob) in zip(runs[True], runs[False]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        assert oa.stats.road_points == ob.stats.road_points > 0
    h = ReplayHarness(checked=True, **CPU)
    out = h._process(torch.from_numpy(pad_scan_planar(scans[0],
                                                      DIMS.max_points)))
    assert type(out) is tuple and len(out) == 2
    assert len(h._fetch_outputs(out)) == 7


def test_outputs_are_five_topics_and_viz_renders(tmp_path):
    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg", force=True)
    from urban_road_filter_torch.viz import LiveViewer, save_scan_png

    got = []
    v = LiveViewer(rate_hz=0.0, out_dir=str(tmp_path / "frames"))
    ReplayHarness(on_scan=lambda o: (got.append(o), v(o)), **CPU).run(
        scene_source("two_curbs", n_scans=2, n_rings=16, n_azimuth=256))
    v.close()
    o = got[0]
    assert isinstance(o, ScanOutputs) and o.ok
    assert len(o.roi) > len(o.road) > 0 and len(o.curb) > 0
    assert o.stats.num_rings > 0 and isinstance(o.marker_strips, list)
    out = tmp_path / "scan.png"
    save_scan_png(o, str(out))
    assert out.stat().st_size > 10000
    assert len(sorted((tmp_path / "frames").glob("frame_*.png"))) == 2


def test_cli_replays_the_pcd_fixtures(tmp_path):
    """python -m urban_road_filter_torch.io.replay --pcd-dir tests/fixtures
    --device cpu: one scan of the fixtures, its stats written."""
    stats = tmp_path / "s.jsonl"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "urban_road_filter_torch.io.replay",
         "--pcd-dir", os.path.join(REPO, "tests", "fixtures"), "--device",
         "cpu", "--scans", "1", "--stats-jsonl", str(stats)],
        check=True, env=env, cwd=REPO, capture_output=True, text=True,
        timeout=300)
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["scans"] == 1 and summary["errors"] == 0
    rec = json.loads(stats.read_text().splitlines()[0])
    assert rec["ok"] and rec["points_in"] == 16384 and rec["overflow"] == 0
    assert replay_mod.__name__ == "urban_road_filter_torch.io.replay"


def test_cli_checked_replays_the_pcd_fixtures():
    """The CLI's --checked runs the fixtures through checked mode: clean."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "urban_road_filter_torch.io.replay",
         "--pcd-dir", os.path.join(REPO, "tests", "fixtures"), "--device",
         "cpu", "--scans", "2", "--checked"],
        check=True, env=env, cwd=REPO, capture_output=True, text=True,
        timeout=300)
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["scans"] == 2 and summary["errors"] == 0
