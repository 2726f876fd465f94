"""The PyTorch port's single-scan slice against the JAX pipeline and the
numpy oracle, on the CPU (the kernels' plain twins).

Structure (ring count, per-ring counts, overflow, ROI) must match the JAX
pipeline exactly.  Labels and markers must match it exactly or differ only
where a one-ulp difference can move them: torch's asin and XLA's differ by
an ulp on ~10 % of azimuths, and XLA's jitted CPU code fuses multiply-adds.
A flip is explained when the point sits within 1e-4 degrees of an integer
azimuth (conftest.assert_labels_exact_or_boundary) or inside the oracle's
own ulp envelope: two oracle runs with every threshold nudged by +-1e-4
relative and the degree edges by +-4e-7 (utils.parity, the envelope the
device gate uses), which covers the flood fill's non-integer window edges
and the cascades they start.  Against the oracle the port passes
``device_parity_gate`` with 0 systematic flips.
"""

import numpy as np
import pytest
import torch

from conftest import assert_marker_rows, marker_rows_boundary_ok
from urban_road_filter_tpu.config import FilterConfig, PipelineDims
from urban_road_filter_tpu.io.synthetic import SCENES
from urban_road_filter_tpu.oracle import run_oracle
from urban_road_filter_tpu.oracle.reference import azimuth_2d
from urban_road_filter_tpu.pipeline import process_scan_jit
from urban_road_filter_tpu.utils.parity import (
    device_parity_gate, nudged_config)
from urban_road_filter_torch import (
    _build, launch_counts, pad_scan, pad_scan_planar, packed_scan,
    process_scan, reset_launch_counts, unpack_planes)
from urban_road_filter_torch.convert import to_numpy
from urban_road_filter_torch.ops import geometry
from urban_road_filter_torch.ops.markers import compact_markers

torch.set_num_threads(1)  # tier-1 runs several pytest workers

DIMS = PipelineDims(max_points=16384, rings=64, ring_capacity=1024)
STAR_FREE = dict(star_shaped_method=False)
# The star-free variants of test_pipeline_parity.TestParityConfigs.
VARIANTS = [dict(x_zero_method=False), dict(z_zero_method=False),
            dict(blind_spots=False), dict(x_direction=1), dict(x_direction=2),
            dict(beam_zone=10.0), dict(beam_zone=45.5), dict(curb_points=3),
            dict(curb_points=10), dict(curb_height=0.12), dict(interval=0.5)]


def _envelope(pts, cfg):
    return [run_oracle(pts, nudged_config(cfg, s * 1e-4), edge_nudge=s * 4e-7)
            for s in (-1, +1)]


def _assert_labels_vs_jax(got, want, pts, roi, orc, env_runs, what):
    n = len(pts)
    assert not (got[n:].any() or want[n:].any())  # padding rows
    assert np.array_equal(got[:n][~roi], want[:n][~roi])
    flips = np.nonzero(got[:n][roi] != want[:n][roi])[0]
    if flips.size == 0:
        return
    rpts = pts[roi]
    _, aa = azimuth_2d(rpts[flips, 0], rpts[flips, 1])
    aa = np.where(np.isnan(aa), 0.5, aa)
    near_bin = np.abs(aa - np.round(aa)) <= 1e-4
    lo, hi = env_runs
    env = ((lo.labels != hi.labels) | (lo.labels != orc.labels)
           | (hi.labels != orc.labels))[flips]
    bad = ~near_bin & ~env
    assert not bad.any(), (
        f"{what}: {int(bad.sum())} unexplained label flips of {flips.size} "
        f"(azimuths {aa[bad][:5].tolist()})")


def _bin_rows(res):
    return {int(b): res.marker_points[i, :3]
            for i, b in enumerate(res.marker_bins)}


def _assert_markers_vs_jax(got_table, want_table, orc, env_runs, what):
    rows, bins = compact_markers(got_table)
    jrows, jbins = compact_markers(want_table)
    if np.array_equal(bins, jbins):
        same = np.all(np.abs(rows[:, :3] - jrows[:, :3]) < 1e-4, axis=1)
        if same.all():
            return
        ok = marker_rows_boundary_ok(rows[:, :3], jrows[:, :3])
        if ok[~same].all():
            return
    views = [_bin_rows(r) for r in (orc, *env_runs)]
    unstable = {b for b in set().union(*views)
                if any(v.get(b) is None for v in views)
                or any(not np.allclose(views[0][b], v[b], atol=1e-4)
                       for v in views[1:])}
    mine = dict(zip(bins.tolist(), rows[:, :3]))
    theirs = dict(zip(jbins.tolist(), jrows[:, :3]))
    left = []
    for b in set(mine) | set(theirs):
        if b in unstable:
            continue
        if b not in mine or b not in theirs:
            left.append(b)
        elif not (np.all(np.abs(mine[b] - theirs[b]) < 1e-4)
                  or marker_rows_boundary_ok(mine[b][None],
                                             theirs[b][None])[0]):
            left.append(b)
    assert not left, f"{what}: unexplained marker bins {sorted(left)[:8]}"


def _check_slice(pts, cfg, what):
    raw = pad_scan(pts, DIMS.max_points)
    port = to_numpy(process_scan(torch.from_numpy(raw), cfg, DIMS,
                                 device="cpu"))
    jx = process_scan_jit(raw, cfg, DIMS)
    orc = run_oracle(pts, cfg)

    assert bool(port.ok) == bool(jx.ok) == orc.ok
    assert int(port.num_rings) == int(jx.num_rings) == orc.num_rings
    np.testing.assert_array_equal(port.counts, np.asarray(jx.counts))
    assert int(port.overflow) == int(jx.overflow) == 0
    np.testing.assert_array_equal(port.roi, np.asarray(jx.roi))
    assert np.mean(port.ring_id == np.asarray(jx.ring_id)) >= 0.9999
    assert port.labels.dtype == np.int8 and port.markers.shape == (361, 6)

    env_runs = _envelope(pts, cfg)
    _assert_labels_vs_jax(port.labels, np.asarray(jx.labels), pts,
                          orc.roi_mask, orc, env_runs, f"{what} labels")
    _assert_markers_vs_jax(port.markers, np.asarray(jx.markers), orc,
                           env_runs, f"{what} markers")
    agree, n_sys = device_parity_gate(pts, port.labels, port.markers, cfg,
                                      what)
    assert n_sys == 0, (what, agree, n_sys)
    return raw, port


class TestSliceScenes:
    @pytest.mark.parametrize("scene", sorted(SCENES))
    def test_scene(self, scene, scene_scans):
        cfg = FilterConfig(**STAR_FREE)
        raw, port = _check_slice(scene_scans[scene], cfg, scene)
        # The packed wire plane round-trips to the three planes.
        packed, markers, ok, num_rings, overflow = (
            t.numpy() for t in packed_scan(torch.from_numpy(raw), cfg, DIMS,
                                          device="cpu"))
        assert packed.dtype == np.uint8
        labels, roi, probably_road = unpack_planes(packed)
        np.testing.assert_array_equal(labels, port.labels)
        np.testing.assert_array_equal(roi, port.roi)
        np.testing.assert_array_equal(probably_road, port.probably_road)
        np.testing.assert_array_equal(markers, port.markers)
        assert (ok, num_rings, overflow) == (port.ok, port.num_rings,
                                             port.overflow)


class TestSliceConfigs:
    @pytest.mark.parametrize("kw", VARIANTS)
    def test_config_variant(self, kw, scene_scans):
        _check_slice(scene_scans["two_curbs"], FilterConfig(**STAR_FREE, **kw),
                     str(kw))


class TestSliceStar:
    """The default configuration: the star-shaped search (K4) on."""

    @pytest.mark.parametrize("scene", sorted(SCENES))
    def test_scene(self, scene, scene_scans):
        _check_slice(scene_scans[scene], FilterConfig(), f"star {scene}")

    @pytest.mark.parametrize("kw", [dict(starbeam_filter=True),
                                    dict(x_direction=1),
                                    dict(curb_slope_deg=20.0),
                                    dict(dmin_param=3)])
    def test_config_variant(self, kw, scene_scans):
        _check_slice(scene_scans["two_curbs"], FilterConfig(**kw),
                     f"star {kw}")


class TestSliceStructure:
    def test_markers_match_oracle(self, scene_scans):
        cfg = FilterConfig(**STAR_FREE)
        pts = scene_scans["two_curbs"]
        port = process_scan(torch.from_numpy(pad_scan(pts, DIMS.max_points)),
                            cfg, DIMS, device="cpu")
        orc = run_oracle(pts, cfg)
        rows, bins = compact_markers(port.markers.numpy())
        np.testing.assert_array_equal(bins, orc.marker_bins)
        assert_marker_rows(rows, orc.marker_points, "two_curbs markers")

    def test_planar_equals_rows(self, scene_scans):
        cfg = FilterConfig(**STAR_FREE)
        pts = scene_scans["curb_gap"]
        rows = to_numpy(process_scan(
            torch.from_numpy(pad_scan(pts, DIMS.max_points)), cfg, DIMS,
            device="cpu"))
        planar = to_numpy(process_scan(
            torch.from_numpy(pad_scan_planar(pts, DIMS.max_points)), cfg,
            DIMS, layout="planar", device="cpu"))
        for f in rows._fields:
            np.testing.assert_array_equal(getattr(planar, f),
                                          getattr(rows, f), err_msg=f)

    def test_under_30_points_gated(self):
        pts = np.tile(np.float32([[1, 0, -2, 0]]), (10, 1))
        out = process_scan(torch.from_numpy(pad_scan(pts, DIMS.max_points)),
                           FilterConfig(**STAR_FREE), DIMS, device="cpu")
        assert not bool(out.ok)
        assert not out.labels.any() and not out.roi.any()
        assert not out.markers.any()

    def test_probably_road_matches_oracle(self, scene_scans):
        cfg = FilterConfig(**STAR_FREE, probably_road_ring=3)
        pts = scene_scans["two_curbs"]
        out = process_scan(torch.from_numpy(pad_scan(pts, DIMS.max_points)),
                           cfg, DIMS, device="cpu")
        orc = run_oracle(pts, cfg)
        got = np.flatnonzero(out.probably_road.numpy()[:len(pts)][
            orc.roi_mask])
        assert len(got) > 0
        np.testing.assert_array_equal(np.sort(got),
                                      np.sort(orc.probably_road_ids))

    def test_cpu_scan_launches_no_kernel(self, scene_scans):
        # On CPU tensors every kernel wrapper takes its plain twin.
        raw = torch.from_numpy(pad_scan(scene_scans["ramp"], DIMS.max_points))
        reset_launch_counts()
        process_scan(raw, FilterConfig(**STAR_FREE), DIMS, device="cpu")
        counts = launch_counts()
        assert set(counts) == set(_build.KERNELS)
        assert not any(counts.values()), counts

    @pytest.mark.parametrize("scene", ["wall", "two_curbs"])
    def test_star_marks_reach_the_labels(self, scene, scene_scans):
        # With the stencils off, every curb label is a star hit: at most
        # one per beam, each on an ROI point, the oracle's own marks.
        pts = scene_scans[scene]
        raw = torch.from_numpy(pad_scan(pts, DIMS.max_points))
        kw = dict(x_zero_method=False, z_zero_method=False)
        star = process_scan(raw, FilterConfig(**kw), DIMS, device="cpu")
        free = process_scan(raw, FilterConfig(**kw, **STAR_FREE), DIMS,
                            device="cpu")
        curbs = (star.labels == 2).numpy()
        assert 0 < curbs.sum() <= 360 and not (free.labels == 2).any()
        assert star.roi.numpy()[curbs].all()
        assert int(star.star_overflow) == 0
        orc = run_oracle(pts, FilterConfig(**kw))
        np.testing.assert_array_equal(
            np.flatnonzero(curbs[:len(pts)][orc.roi_mask]),
            np.flatnonzero(orc.labels == 2))


class TestProbablyRoadWithoutRing:
    """probably_road_ring == dims.rings, the ring id of every point without
    a ring (outside the ROI, padding, unbinned): no point is flagged, on any
    path and over all N points, as the oracle returns none; the packed
    plane's bit 3 follows.  The JAX package flags every such point."""

    CFG = FilterConfig(**STAR_FREE, probably_road_ring=DIMS.rings)

    def _pts(self, scene_scans):
        return scene_scans["two_curbs"]

    @pytest.mark.parametrize("path", ["scan", "packed", "batch", "sp"])
    def test_no_point_flagged(self, path, scene_scans):
        from urban_road_filter_torch import process_batch
        from urban_road_filter_torch.convert import filter_config
        from urban_road_filter_torch.parallel.azimuth_parallel import (
            azimuth_sorted, make_azimuth_pipeline)

        pts = self._pts(scene_scans)
        if path == "sp":
            pts = azimuth_sorted(pts)
        raw = torch.from_numpy(pad_scan(pts, DIMS.max_points))
        if path == "packed":
            packed = packed_scan(raw, self.CFG, DIMS, device="cpu")[0]
            flags = unpack_planes(packed.numpy())[2]
            assert not (packed.numpy() & 8).any()
        elif path == "batch":
            out = process_batch(raw[None].repeat(2, 1, 1), self.CFG, DIMS,
                                device="cpu")
            flags = out.probably_road.numpy()
        elif path == "sp":
            run = make_azimuth_pipeline(8, filter_config(self.CFG), DIMS,
                                        device="cpu")
            out = run(raw)
            flags = out.probably_road.numpy()
            assert (out.ring_id.numpy() == DIMS.rings).any()
        else:
            out = process_scan(raw, self.CFG, DIMS, device="cpu")
            flags = out.probably_road.numpy()
            assert (out.ring_id.numpy() == DIMS.rings).sum() > len(pts) // 10
        assert flags.size >= DIMS.max_points and not flags.any()
        assert len(run_oracle(pts, self.CFG).probably_road_ids) == 0

    def test_jax_package_flags_points_without_a_ring(self, scene_scans):
        raw = pad_scan(self._pts(scene_scans), DIMS.max_points)
        jx = process_scan_jit(raw, self.CFG, DIMS)
        flags = np.asarray(jx.probably_road)
        np.testing.assert_array_equal(
            flags, np.asarray(jx.ring_id) == DIMS.rings)
        assert flags.sum() > 0


class TestSliceStencilsOff:
    """The x/z-zero stencils off, the star search on: every curb is a star
    hit.  Classified against the oracle with device_parity_gate, for the
    port and for the JAX package.  On two_curbs, blind_spot and curb_gap a
    star-hit curb sits at the 2-D azimuth 60.0 in the oracle (float64 asin,
    rounded once), the lower end of the forward window of start 60.  An f32
    asin rounded twice put it at 59.999996, outside that window, and the
    gate rejected the marker row of bin 60.  The port now computes the
    azimuth as the oracle does (geometry.azimuth_2d), so it is bit-equal to
    the oracle's on every ROI point and the gate passes for the port and
    for the JAX package alike, with 0 systematic flips; the gate is not
    widened."""

    CFG = FilterConfig(x_zero_method=False, z_zero_method=False)

    @pytest.mark.parametrize("scene", ["two_curbs", "blind_spot",
                                       "curb_gap"])
    def test_port_flips_sit_one_ulp_below_start_60(self, scene, scene_scans):
        pts = scene_scans[scene]
        raw = pad_scan(pts, DIMS.max_points)
        port = to_numpy(process_scan(torch.from_numpy(raw), self.CFG, DIMS,
                                     device="cpu"))
        agree, n_sys = device_parity_gate(pts, port.labels, port.markers,
                                          self.CFG, f"stencils off {scene}")
        assert agree >= 0.999 and n_sys == 0
        jx = process_scan_jit(raw, self.CFG, DIMS)
        agree, n_sys = device_parity_gate(
            pts, np.asarray(jx.labels), np.asarray(jx.markers), self.CFG,
            f"JAX stencils off {scene}")
        assert agree >= 0.999 and n_sys == 0

        orc = run_oracle(pts, self.CFG)
        roi = orc.roi_mask
        rpts = pts[roi]
        _, a_orc = azimuth_2d(rpts[:, 0], rpts[:, 1])
        _, a_port = (t.numpy() for t in geometry.azimuth_2d(
            torch.from_numpy(rpts[:, 0].copy()),
            torch.from_numpy(rpts[:, 1].copy())))
        np.testing.assert_array_equal(a_port.view(np.int32),
                                      a_orc.view(np.int32))
        # The mechanism of the old flip: ROI points at exactly 60.0 that an
        # f32 asin, rounded before the quadrant offset, put one ulp below.
        x, y = (torch.from_numpy(rpts[:, k].copy()) for k in (0, 1))
        d2 = geometry.sqrt_rn(x * x + y * y)
        deg = torch.asin(torch.clamp(torch.abs(x) / d2, -1.0, 1.0)) * float(
            np.float32(180.0 / np.pi))
        a_f32 = torch.where((x >= 0) & (y > 0), 180.0 - deg, deg).numpy()
        sixty = np.float32(60.0)
        assert ((a_orc == sixty) & (a_f32 == np.nextafter(
            sixty, np.float32(0)))).any()
