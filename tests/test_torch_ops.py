"""The PyTorch port's modules against the JAX package's CPU formulations.

Each module of the port that holds a kernel (K4 star walk, K5 rank, K6
place, K7 x/z-zero stencils, K8 + K9 flood fill, K10 markers, K11 gather) is
held here, through its plain PyTorch twin, against the JAX function it
replaces, on the same numpy inputs; the star walk also against the numpy
oracle's literal walk, which it follows rounding for rounding.  The JAX
functions run eagerly (op by op): XLA's jitted CPU code contracts a*b + c
into fused multiply-adds, which neither the torch twins nor the CUDA
kernels (``nvcc --fmad=false``) do, and the eager ops are what
tests/test_pallas_interpret.py pins bit-equal to the Pallas kernels.
Tolerance: exact everywhere except vertical angles, where torch's acos/asin
and XLA's differ by an ulp; the 2-D azimuth, which is bit-equal to the
oracle's and within two ulp of the JAX package's where the two packages'
f32 brackets agree, the JAX package's everywhere within two ulp of the
oracle's recipe on its own bracket (tests/torch_azimuth.py); and the star
hits against the JAX package's prefix-sum walk (at most 2 beams of 360).
"""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from urban_road_filter_tpu.config import FilterConfig
from urban_road_filter_tpu.io.synthetic import SCENES, make_scan
from urban_road_filter_tpu.oracle import reference as oracle
from urban_road_filter_tpu.ops import blind_spots as jbs
from urban_road_filter_tpu.ops import geometry as jgeo
from urban_road_filter_tpu.ops import markers as jmk
from urban_road_filter_tpu.ops.gather import gather_by_group_pos as jgather
from urban_road_filter_tpu.ops.rank import _xla_rank
from urban_road_filter_tpu.ops.star import star_hits as jstar_hits
from urban_road_filter_tpu.ops.xzero import x_zero as jx_zero
from urban_road_filter_tpu.ops.zzero import z_zero as jz_zero
from urban_road_filter_torch.convert import layout_from_numpy, to_numpy
from urban_road_filter_torch.ops import blind_spots as tbs
from urban_road_filter_torch.ops import geometry as tgeo
from urban_road_filter_torch.ops import markers as tmk
from urban_road_filter_torch.ops import star as tstar
from urban_road_filter_torch.ops.gather import (
    gather_by_group_pos, gather_pack)
from urban_road_filter_torch.ops.place import group_place
from urban_road_filter_torch.ops.rank import group_positions
from urban_road_filter_torch.ops.stencil_kernels import fused_xz_zero
from star_streams import scatter_streams, walk_streams
from ring_geometry_cases import CASES as RING_CASES
from ring_geometry_cases import (glue_of_record, ring_geometry_case,
                                 same_bits, star_labels_of_record)
from torch_azimuth import assert_azimuth

torch.set_num_threads(1)  # tier-1 runs several pytest workers

F32 = np.float32
I32 = np.int32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.array(a))


def _ulps(a, b):
    """Per-element distance in f32 ulps (NaN == NaN counts 0)."""
    a = np.asarray(a, F32).view(I32).astype(np.int64)
    b = np.asarray(b, F32).view(I32).astype(np.int64)
    return np.abs(a - b)


def _scene_xyz(scene="two_curbs", seed=0):
    pts = make_scan(SCENES[scene](), n_rings=24, n_azimuth=384, seed=seed)
    return [np.ascontiguousarray(pts[:, k]) for k in range(3)]


def _jax_ring_ids(x, y, z, cfg):
    """Ring ids from the JAX package (eager ops)."""
    jx, jy, jz = map(jnp.asarray, (x, y, z))
    valid = jgeo.roi_mask_xyz(jx, jy, jz, cfg)
    _, av = jgeo.vertical_angles(jx, jy, jz)
    angles, _ = jgeo.discover_rings(av, valid, cfg.interval)
    return np.asarray(jgeo.assign_rings(av, valid, angles, cfg.interval))


def _jax_layout(scene="two_curbs", seed=0, cap=512, cfg=None):
    cfg = cfg or FilterConfig()
    x, y, z = _scene_xyz(scene, seed)
    ring_id = _jax_ring_ids(x, y, z, cfg)
    layout, _ = jgeo.tensorize(*map(jnp.asarray, (x, y, z, ring_id)), cap)
    return layout


class TestGeometry:
    @pytest.mark.parametrize("scene", ["two_curbs", "wall", "blind_spot"])
    def test_roi_angles_and_rings(self, scene):
        cfg = FilterConfig()
        x, y, z = _scene_xyz(scene, 3)
        jx, jy, jz = map(jnp.asarray, (x, y, z))
        tx, ty, tz = map(_t, (x, y, z))
        valid = tgeo.roi_mask_xyz(tx, ty, tz, cfg)
        np.testing.assert_array_equal(
            valid.numpy(), np.asarray(jgeo.roi_mask_xyz(jx, jy, jz, cfg)))
        _, jav = jgeo.vertical_angles(jx, jy, jz)
        d, tav = tgeo.vertical_angles(tx, ty, tz)
        np.testing.assert_array_equal(
            d.numpy(), np.asarray(jgeo.vertical_angles(jx, jy, jz)[0]))
        assert _ulps(tav.numpy(), jav).max() <= 2

        jangles, jn = jgeo.discover_rings(jav, jnp.asarray(valid.numpy()),
                                          cfg.interval)
        tangles, tn = tgeo.discover_rings(tav, valid, cfg.interval)
        assert int(tn) == int(jn) > 0
        fin = np.isfinite(np.asarray(jangles))
        np.testing.assert_array_equal(np.isfinite(tangles.numpy()), fin)
        assert _ulps(tangles.numpy()[fin], np.asarray(jangles)[fin]).max() <= 2
        jring = np.asarray(jgeo.assign_rings(jav, jnp.asarray(valid.numpy()),
                                             jangles, cfg.interval))
        tring = tgeo.assign_rings(tav, valid, tangles, cfg.interval).numpy()
        assert tring.dtype == np.int32
        # asin/acos may differ by an ulp between torch and XLA, which moves
        # a point sitting on a ring's +-interval edge (as in
        # test_ring_assignment_matches).
        assert np.mean(tring == jring) >= 0.9999

    def test_azimuth_and_max_distance(self):
        layout = _jax_layout("blind_spot", 1)
        tl = layout_from_numpy(layout)
        d2, alpha = tgeo.azimuth_2d(tl.x, tl.y)
        np.testing.assert_array_equal(d2.numpy(), np.asarray(layout.d2))
        assert_azimuth(tl.x.numpy(), tl.y.numpy(), alpha.numpy(),
                       layout.alpha, oracle.azimuth_2d)
        np.testing.assert_array_equal(
            tgeo.max_distance(tl).numpy(),
            np.asarray(jgeo.max_distance(layout)))

    @pytest.mark.parametrize("case", RING_CASES)
    def test_ring_geometry_twin(self, case):
        """ring_geometry's plain twin bit-equal to the glue it replaced (the
        record, tests/ring_geometry_cases.py), with each set of planes its
        callers ask for (every plane; d2, alpha and the max; d2 and
        alpha); and the kernel's rule (csrc/ring_geometry.cu: the recipe
        on the slots below counts, d2 0 and alpha NaN past them, no
        arithmetic there) equal to the twin on layouts whose empty slots
        hold +-0.0, as K6's do.  Scan (R, P), batch (B, R, P) with an
        empty lane and SP (wedges * R, P) layouts from tensorize, rows at
        capacity among them; and hand-made rows: an empty row, quadrant
        edges (x or y +-0.0 beside each sign of the other), NaN
        coordinates, -0.0 in the tail, an f32 overflow, counts past P.
        One case a test, the forms in a loop: this file's item count sets
        its place in pytest-xdist's loadfile queue, and the JAX retrace
        test (tests/test_config_dynamic.py) fails on a worker that ran
        tests/test_pipeline_parity.py before it."""
        x, y, counts = ring_geometry_case(case)
        want = glue_of_record(x, y, counts)
        if case != "edges":
            assert (counts == x.shape[-1]).any() and (counts == 0).any()
        for fills in (True, False):
            got = tgeo.ring_geometry(x, y, counts, fills=fills)
            same_bits(got.d2, want.d2)
            same_bits(got.alpha, want.alpha)
            if fills:
                assert torch.equal(got.label, want.label)
                assert torch.equal(got.pid, want.pid)
            else:
                assert got.label is None and got.pid is None
            same_bits(got.max_distance, want.max_distance)

        # The kernel's rule, in numpy, per slot.
        xn, yn = x.numpy(), y.numpy()
        slot = np.arange(xn.shape[-1])
        valid = slot < np.clip(counts.numpy(), 0, xn.shape[-1])[..., None]
        assert (xn[~valid] == 0).all() and (yn[~valid] == 0).all()
        with np.errstate(invalid="ignore", over="ignore"):
            d2 = np.where(valid, np.sqrt(xn * xn + yn * yn), F32(0))
            alpha = np.where(valid, oracle.azimuth_2d(xn, yn)[1],
                             F32(np.nan))
        same_bits(want.d2, torch.from_numpy(d2))
        same_bits(want.alpha, torch.from_numpy(alpha))
        row_max = np.where(np.isnan(d2).any(-1), np.nan, np.nanmax(
            np.where(np.isnan(d2), 0, d2), -1)).astype(F32)
        same_bits(want.max_distance, torch.from_numpy(row_max))

    def test_orientation_is_explicit(self):
        # Four points: (4, 4) rows and (3, 4) planar.  The JAX package reads
        # any trailing dim of 4 as rows (ADVICE r5 fault 3); the port reads
        # the orientation it is told.
        rng = np.random.default_rng(0)
        rows = rng.standard_normal((4, 4)).astype(F32)
        planar = np.ascontiguousarray(rows[:, :3].T)  # (3, 4)
        x, y, z, n = tgeo.xyz_of(_t(planar), "planar")
        assert n == 4
        for got, want in zip((x, y, z), planar):
            np.testing.assert_array_equal(got.numpy(), want)
        x, y, z, n = tgeo.xyz_of(_t(rows), "rows")
        assert n == 4
        for k, got in enumerate((x, y, z)):
            np.testing.assert_array_equal(got.numpy(), rows[:, k])
        # The same (3, 4) array named as rows is 3 points of 4 columns.
        assert tgeo.xyz_of(_t(planar), "rows")[3] == 3
        with pytest.raises(ValueError):
            tgeo.xyz_of(_t(rows), "planar")
        with pytest.raises(ValueError):
            tgeo.xyz_of(_t(rows), "auto")


class TestRank:
    @pytest.mark.parametrize("n,groups,seed", [(300, 5, 0), (4096, 65, 1),
                                               (5000, 361, 2),
                                               (16384, 65, 3)])
    def test_matches_xla_rank(self, n, groups, seed):
        ids = np.random.default_rng(seed).integers(0, groups, n).astype(I32)
        pos, counts = group_positions(_t(ids), groups)
        jpos, jcounts = _xla_rank(jnp.asarray(ids), groups)
        assert pos.dtype == counts.dtype == torch.int32
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))

    def test_single_group(self):
        pos, counts = group_positions(torch.zeros(1000, dtype=torch.int32), 4)
        np.testing.assert_array_equal(pos.numpy(), np.arange(1000))
        np.testing.assert_array_equal(counts.numpy(), [1000, 0, 0, 0])


class TestPlace:
    @pytest.mark.parametrize("scene,cap", [("two_curbs", 1024),
                                           ("blind_spot", 1024),
                                           ("two_curbs", 64)])
    def test_tensorize_matches_jax(self, scene, cap):
        cfg = FilterConfig()
        x, y, z = _scene_xyz(scene, 2)
        ring_id = _jax_ring_ids(x, y, z, cfg)
        jl, jpos = jgeo.tensorize(*map(jnp.asarray, (x, y, z, ring_id)), cap,
                                  rings=64)
        tl, tpos, tmax = tgeo.tensorize(*map(_t, (x, y, z, ring_id)), cap,
                                        rings=64)
        np.testing.assert_array_equal(tmax.numpy(),
                                      np.asarray(jgeo.max_distance(jl)))
        tl = to_numpy(tl)
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        for f in ("x", "y", "z", "d2", "label", "pid", "counts", "overflow"):
            got, want = getattr(tl, f), np.asarray(getattr(jl, f))
            assert got.dtype == want.dtype, f
            np.testing.assert_array_equal(got, want, err_msg=f)
        assert_azimuth(tl.x, tl.y, tl.alpha, jl.alpha, oracle.azimuth_2d)
        if cap == 64:
            assert int(tl.overflow) > 0  # the over-capacity case

    def test_dropped_points_do_not_land(self):
        # ids == rings (dropped at binning) and pos >= capacity contribute
        # nowhere, even with non-finite values.
        rng = np.random.default_rng(1)
        n, rings, cap = 1024, 8, 64
        ids = rng.integers(0, rings + 1, n).astype(I32)
        pos, counts = group_positions(_t(ids), rings + 1)
        pos_np = pos.numpy()
        vals = [rng.standard_normal(n).astype(F32) for _ in range(3)]
        for v in vals:
            v[(ids == rings) | (pos_np >= cap)] = np.nan
        ox, oy, oz, overflow = group_place(_t(ids), pos, counts,
                                           tuple(map(_t, vals)), rings, cap)
        want = [np.zeros((rings, cap), F32) for _ in range(3)]
        for i in range(n):
            if ids[i] < rings and pos_np[i] < cap:
                for w, v in zip(want, vals):
                    w[ids[i], pos_np[i]] = v[i]
        for got, w in zip((ox, oy, oz), want):
            np.testing.assert_array_equal(got.numpy(), w)
        in_ring = ids < rings
        assert int(overflow) == int(np.sum(in_ring & (pos_np >= cap)))
        assert int(overflow) > 0


class TestStencils:
    @pytest.mark.parametrize("cp", [3, 5, 10])
    @pytest.mark.parametrize("scene", ["two_curbs", "high_curbs", "ramp"])
    def test_fused_matches_xla_stencils(self, scene, cp):
        cfg = FilterConfig(curb_points=cp)
        layout = _jax_layout(scene, 4, cfg=cfg)
        want = np.asarray(jz_zero(jx_zero(layout, cfg), cfg).label)
        got = fused_xz_zero(layout_from_numpy(layout), cfg).label.numpy()
        assert want.max() > 0  # the scene must actually trigger marks
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("kw", [dict(x_zero_method=False),
                                    dict(z_zero_method=False),
                                    dict(x_zero_method=False,
                                         z_zero_method=False)])
    def test_method_toggles(self, kw):
        cfg = FilterConfig(**kw)
        layout = _jax_layout("two_curbs", 5, cfg=cfg)
        want = layout
        if cfg.x_zero_method:
            want = jx_zero(want, cfg)
        if cfg.z_zero_method:
            want = jz_zero(want, cfg)
        got = fused_xz_zero(layout_from_numpy(layout), cfg).label.numpy()
        np.testing.assert_array_equal(got, np.asarray(want.label))

    @pytest.mark.parametrize("cp", [3, 5, 10])
    def test_empty_and_short_rings(self, cp):
        # Ring 0: many points; ring 1: 3 points (short); rings 2+: empty.
        cfg = FilterConfig(curb_points=cp)
        rng = np.random.default_rng(3)
        n = 512
        ring_id = np.zeros(n, I32)
        ring_id[200:203] = 1
        x = rng.standard_normal(n).astype(F32)
        y = rng.standard_normal(n).astype(F32)
        z = (rng.standard_normal(n) * 0.3).astype(F32)
        layout, _ = jgeo.tensorize(*map(jnp.asarray, (x, y, z, ring_id)), 512)
        want = np.asarray(jz_zero(jx_zero(layout, cfg), cfg).label)
        got = fused_xz_zero(layout_from_numpy(layout), cfg).label.numpy()
        np.testing.assert_array_equal(got, want)
        assert got[1].max() == 0 and got[2:].max() == 0


def _stenciled(scene, seed, cfg):
    layout = _jax_layout(scene, seed, cfg=cfg)
    return jz_zero(jx_zero(layout, cfg), cfg)


def _first_nonroad(layout, num_rings):
    """{bin: (ring, alpha, slot)} of each one-degree bin's first non-road
    point in the reference's traversal order, by brute force."""
    first = {}
    for r in range(num_rings):
        for s in range(int(layout.counts[r])):
            a = float(layout.alpha[r, s])
            if 0.0 <= a <= 360.0 and layout.label[r, s] != 1:
                b = int(np.floor(a))
                first[b] = min(first.get(b, (r, a, s)), (r, a, s))
    return first


class TestBlindSpots:
    @pytest.mark.parametrize("kw", [dict(), dict(blind_spots=False),
                                    dict(x_direction=1), dict(x_direction=2),
                                    dict(beam_zone=10.0),
                                    dict(beam_zone=45.5)])
    @pytest.mark.parametrize("scene", ["two_curbs", "blind_spot", "curb_gap"])
    def test_matches_xla(self, scene, kw):
        cfg = FilterConfig(**kw)
        layout = _stenciled(scene, 6, cfg)
        max_dist = jgeo.max_distance(layout)
        num_rings = jnp.sum(layout.counts > 0).astype(jnp.int32)
        want = np.asarray(jbs.blind_spots(layout, max_dist, num_rings,
                                          cfg).label)
        got, kf = tbs.blind_spots(layout_from_numpy(layout), _t(max_dist),
                                  _t(num_rings), cfg)
        assert (want == 1).any()
        np.testing.assert_array_equal(got.label.numpy(), want)
        # The fused marker pass: each bin's first non-road point in scan
        # order (rings outward, each ring by azimuth, ties in input order).
        kf = kf.numpy()
        first = _first_nonroad(to_numpy(got), int(num_rings))
        have = kf != np.iinfo(np.int64).max
        np.testing.assert_array_equal(np.flatnonzero(have), sorted(first))
        for b, (ring, _, slot) in first.items():
            assert (kf[b] >> 48, kf[b] & 0xFFFF) == (ring, slot), b

    @pytest.mark.parametrize("bz", [10.0, 30.0, 45.5])
    def test_window_bounds(self, bz):
        max_dist = np.linspace(3.0, 40.0, 64).astype(F32)
        max_dist[50:] = 0.0  # empty rings: infinite windows
        w = tbs.window_widths(_t(max_dist), bz)
        jw = jbs.window_widths(jnp.asarray(max_dist), bz)
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        for direction in (+1, -1):
            got = tbs.sweep_bounds(w, bz, direction)
            want = jbs.sweep_bounds(jw, bz, direction)
            for g, wv in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(wv))


def _markers(layout, num_rings):
    """The port's marker table on an (unsorted) JAX layout."""
    tl = layout_from_numpy(layout)
    nr = _t(num_rings)
    return tmk.marker_points(tl, nr, tmk.first_nonroad_keys(tl, nr)).numpy()


class TestMarkers:
    @pytest.mark.parametrize("scene", ["two_curbs", "blind_spot", "flat"])
    def test_matches_xla_on_sorted_layout(self, scene):
        # The JAX reference runs on the azimuth-sorted layout; the port's
        # scan-order keys reach the same table from the unsorted one.
        cfg = FilterConfig()
        layout = _stenciled(scene, 7, cfg)
        num_rings = jnp.sum(layout.counts > 0).astype(jnp.int32)
        layout = jbs.blind_spots(layout, jgeo.max_distance(layout), num_rings,
                                 cfg)
        want = np.asarray(jmk.marker_points(jgeo.sort_by_azimuth(layout),
                                            num_rings))
        got = _markers(layout, num_rings)
        assert want[:, 0].sum() > 0
        np.testing.assert_array_equal(got, want)
        for g, w in zip(tmk.compact_markers(got), jmk.compact_markers(want)):
            np.testing.assert_array_equal(g, w)

    def test_keys_follow_scan_order(self):
        # Keys order like (ring, azimuth, slot): equal azimuths keep input
        # order, and an azimuth of -0.0 keys like 0.0.
        alpha = np.array([[5.5, 0.0, 5.5, 359.0], [-0.0, 1.0, 0.5, 360.0]],
                         F32)
        keys = tmk.marker_keys(_t(alpha)).numpy()
        order = np.lexsort((np.arange(4)[None].repeat(2, 0).ravel(),
                            alpha.ravel(), np.repeat([0, 1], 4)))
        np.testing.assert_array_equal(np.argsort(keys.ravel(), kind="stable"),
                                      order)
        assert keys[1, 0] == (1 << 48)

    def test_duplicate_distance_tie_and_hidden_road(self):
        # Bin 10: two road points at the same distance (the first in scan
        # order wins); bin 20: a non-road point hides the road behind it.
        # The JAX reference reads the azimuth-sorted layout; the port reads
        # it with ring 0's points in reverse order.
        r, p = 4, 8
        x = np.zeros((r, p), F32)
        y = np.zeros((r, p), F32)
        label = np.zeros((r, p), I32)
        alpha = np.full((r, p), np.nan, F32)
        counts = np.array([3, 3, 0, 0], I32)
        alpha[0, :3] = [10.2, 10.7, 20.5]
        alpha[1, :3] = [10.4, 20.1, 20.9]
        x[0, :3] = [3.0, 4.0, 6.0]
        y[0, :3] = [4.0, 3.0, 8.0]
        x[1, :3] = [0.0, 9.0, 1.0]
        y[1, :3] = [5.0, 0.0, 1.0]
        label[0, :3] = [1, 1, 0]
        label[1, :3] = [1, 1, 1]
        d2 = np.sqrt(x * x + y * y).astype(F32)
        fields = [x, y, np.zeros_like(x), d2, alpha, label,
                  np.full((r, p), -1, I32), counts, np.int32(0)]
        want = np.asarray(jmk.marker_points(
            jgeo.RingLayout(*map(jnp.asarray, fields)), jnp.int32(2)))
        for f in fields[:6]:
            f[0, :3] = f[0, 2::-1].copy()
        got = _markers(jgeo.RingLayout(*fields), np.int32(2))
        np.testing.assert_array_equal(got, want)
        assert got[10, 0] == 1 and got[10, 1] == 3.0  # first of the tie
        assert got[20, 0] == 0 and got[20, 4] == 1  # hidden behind non-road

    def test_empty(self):
        layout = layout_from_numpy(_jax_layout("flat", 0))
        empty = layout._replace(counts=torch.zeros_like(layout.counts))
        nr = torch.tensor(0, dtype=torch.int32)
        got = tmk.marker_points(empty, nr, tmk.first_nonroad_keys(empty, nr))
        assert got.shape == (361, 6)
        assert not got[:, [0, 1, 2, 3, 4]].any()
        np.testing.assert_array_equal(got[:, 5].numpy(), np.arange(361))


def _oracle_walk(fk, r, z, pid, cfg):
    hp = np.zeros(360, I32)
    for b in range(360):
        seg = np.flatnonzero(fk == b)
        if seg.size < 2:
            continue
        i = oracle._beam_walk(r[seg], z[seg], cfg.slope_param,
                              F32(cfg.kdev_param), F32(cfg.kdist_param),
                              int(cfg.dmin_param))
        if i >= 0:
            hp[b] = pid[seg[i]] + 1
    return hp


class TestStar:
    @pytest.mark.parametrize("seed,kw", [
        (0, dict()), (1, dict(curb_slope_deg=20.0)),
        (2, dict(kdev_param=0.6, dmin_param=3)),
        (3, dict(kdist_param=9.0, dmin_param=30))])
    def test_walk_matches_oracle(self, seed, kw):
        # K4's plain version on the unsorted inputs of the beam-sorted
        # streams, and the plain walk on the streams themselves.
        cfg = FilterConfig(**kw)
        streams = walk_streams(seed)
        (fk, r, z), pid = scatter_streams(streams, seed)
        want = _oracle_walk(*streams[:3], pid, cfg)
        got = tstar.star_search(_t(fk), _t(r), _t(z), cfg).numpy()
        assert 30 < np.count_nonzero(want) < 358
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tstar.star_walk_plain(
            *map(_t, (*streams[:3], pid)), cfg).numpy(), want)

    @pytest.mark.parametrize("kw", [dict(), dict(starbeam_filter=True)])
    @pytest.mark.parametrize("scene", ["two_curbs", "wall", "ramp"])
    def test_hits_match_oracle_and_jax(self, scene, kw):
        cfg = FilterConfig(**kw)
        x, y, z = _scene_xyz(scene, 5)
        valid = tgeo.roi_mask_xyz(_t(x), _t(y), _t(z), cfg)
        hp = tstar.star_hits(_t(x), _t(y), _t(z), valid, cfg).numpy()
        v = valid.numpy()
        marks = np.zeros(int(v.sum()), np.int16)
        oracle.star_shaped_search(x[v], y[v], z[v], marks, cfg)
        want = np.flatnonzero(v)[marks == 2]
        np.testing.assert_array_equal(np.sort(hp[hp > 0] - 1), want)
        # The JAX package sums the walk's statistics as segmented prefix
        # sums and bins by a float32 atan2: a beam or two of 360 may
        # differ from the oracle's sequential walk there.
        pts = np.stack([x, y, z, np.zeros_like(x)], axis=1)
        jhp = np.asarray(jstar_hits(jnp.asarray(pts), jnp.asarray(v),
                                    cfg)[0])
        assert np.count_nonzero(jhp != hp) <= 2

    def test_streams_are_beam_sorted(self):
        cfg = FilterConfig()
        x, y, z = _scene_xyz("curb_gap", 1)
        valid = tgeo.roi_mask_xyz(_t(x), _t(y), _t(z), cfg)
        fk, r, zs, pid = (t.numpy() for t in tstar.beam_streams(
            _t(x), _t(y), _t(z), valid, cfg))
        order = np.lexsort((np.arange(x.size), r[np.argsort(pid)],
                            fk[np.argsort(pid)]))
        np.testing.assert_array_equal(pid, order)
        np.testing.assert_array_equal(zs, z[pid])
        assert (fk[~valid.numpy()[pid]] == 360).all()
        assert np.isinf(r[fk == 360]).all()

    def test_labels_land_only_inside_the_layout(self):
        ring_id = _t(np.array([0, 1, 3, 1, 0, 2], I32))  # 3: dropped
        pos = _t(np.array([0, 0, 0, 1, 4, 0], I32))  # 4: over capacity
        hp = _t(np.zeros(360, I32))
        hp[[5, 6, 7, 8]] = _t(np.array([2, 3, 5, 6], I32))  # points 1,2,4,5
        plane = torch.zeros((3, 4), dtype=torch.int32)
        lab = tstar.star_labels(hp, ring_id, pos, plane)
        assert lab is plane
        lab = lab.numpy()
        np.testing.assert_array_equal(lab, star_labels_of_record(
            hp, ring_id, pos, plane).numpy())
        want = np.zeros((3, 4), I32)
        want[1, 0] = want[2, 0] = 2
        np.testing.assert_array_equal(lab, want)


class TestGather:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_matches_fancy_index(self, seed):
        rng = np.random.default_rng(seed)
        r, p, n = 64, 256, 5000
        table = rng.integers(0, 3, (r, p)).astype(I32)
        ids = rng.integers(-3, r + 3, n).astype(I32)
        pos = rng.integers(-3, p + 3, n).astype(I32)
        ids[:4] = [-1, 0, r, 5]
        pos[:4] = [0, -1, 0, p]
        inr = (ids >= 0) & (ids < r) & (pos >= 0) & (pos < p)
        want = np.where(inr, table[np.clip(ids, 0, r - 1),
                                   np.clip(pos, 0, p - 1)], 0)
        got = gather_by_group_pos(_t(table), _t(ids), _t(pos)).numpy()
        np.testing.assert_array_equal(got, want)
        assert not got[:4].any()  # negative and over-range indices read 0
        jgot = np.asarray(jgather(jnp.asarray(table), jnp.asarray(ids),
                                  jnp.asarray(pos)))
        np.testing.assert_array_equal(got, jgot)

    @pytest.mark.parametrize("ok", [True, False])
    def test_gate_and_pack(self, ok):
        rng = np.random.default_rng(2)
        r, p, n = 64, 256, 3000
        table = rng.integers(0, 3, (r, p)).astype(I32)
        ids = rng.integers(-2, r + 2, n).astype(I32)
        pos = rng.integers(-2, p + 2, n).astype(I32)
        valid = rng.random(n) < 0.7
        labels, roi, pr, packed = gather_pack(
            _t(table), _t(ids), _t(pos), _t(valid), torch.tensor(ok), 10)
        inr = (ids >= 0) & (ids < r) & (pos >= 0) & (pos < p)
        want_l = np.where(inr & ok, table[np.clip(ids, 0, r - 1),
                                          np.clip(pos, 0, p - 1)], 0)
        assert labels.dtype == torch.int8 and packed.dtype == torch.uint8
        np.testing.assert_array_equal(labels.numpy(), want_l)
        np.testing.assert_array_equal(roi.numpy(), valid & ok)
        np.testing.assert_array_equal(pr.numpy(), (ids == 10) & ok)
        np.testing.assert_array_equal(
            packed.numpy(), want_l | (valid & ok) << 2 | ((ids == 10) & ok) << 3)


def test_port_imports_no_jax():
    """Importing the port, its oracle, its parity gate, its SP path, its
    replay harness and host modules, checked mode, the profiling hooks,
    the data-parallel path, chip_smoke, the port's demo and soak tool
    loads neither JAX nor the JAX package."""
    code = ("import sys; import urban_road_filter_torch, "
            "urban_road_filter_torch.convert, urban_road_filter_torch.oracle, "
            "urban_road_filter_torch.utils.parity, "
            "urban_road_filter_torch.parallel.azimuth_parallel, chip_smoke, "
            "urban_road_filter_torch.io.replay, "
            "urban_road_filter_torch.io.pcd, urban_road_filter_torch.io.rosbag, "
            "urban_road_filter_torch.runtime.native, "
            "urban_road_filter_torch.postprocess, urban_road_filter_torch.viz, "
            "urban_road_filter_torch.utils.metrics, "
            "urban_road_filter_torch.utils.checked, "
            "urban_road_filter_torch.utils.profiling, "
            "urban_road_filter_torch.parallel.data_parallel; "
            "sys.path.insert(0, 'tools'); import soak_stream_torch; "
            "sys.path.insert(0, 'examples'); import demo_torch; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'urban_road_filter_tpu')); "
            "assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO, timeout=120)


def test_port_sources_never_import_the_jax_package():
    """No source file of the port, not chip_smoke.py, the port's demo or
    its soak tool imports JAX or the JAX package, even a module of it that
    does not import JAX."""
    pattern = re.compile(
        r"^\s*(import|from)\s+(urban_road_filter_tpu|jax|jaxlib)\b",
        re.MULTILINE)
    root = pathlib.Path(REPO)
    files = sorted((root / "urban_road_filter_torch").rglob("*.py"))
    files += [root / "chip_smoke.py", root / "tools" / "soak_stream_torch.py",
              root / "examples" / "demo_torch.py"]
    assert len(files) > 20
    for name in ("io/replay.py", "io/pcd.py", "io/rosbag.py", "viz.py",
                 "postprocess.py", "runtime/native.py", "utils/metrics.py",
                 "utils/checked.py", "utils/profiling.py",
                 "parallel/data_parallel.py"):
        assert root / "urban_road_filter_torch" / name in files, name
    bad = [str(f.relative_to(root)) for f in files
           if pattern.search(f.read_text())]
    assert not bad, bad
