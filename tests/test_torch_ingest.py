"""The port's batch ingest (ops/ingest.py: K1 ingest_prep, K2
discover_rings, K3 assign_rings) against the JAX package, on the CPU.

The plain twins run here; the same numpy arrays (the same vertical angles
included) go to the twin, to the JAX package's eager XLA formulations and
to its Pallas kernels in interpret mode, so exactness is a fair demand:

  * K1: valid and piece exact; r_key exact against the eager
    ``jnp.sqrt(x*x + y*y)`` and within 1 ulp of the interpreted kernel,
    which contracts the sum into a fused multiply-add on the CPU; fk exact
    against the oracle's binning (the float64 atan2), and against the JAX
    package's float32-atan2 fk only where the two atan2s round to the same
    float32 (the test counts the points where they do not).
  * K2 and K3: angles, counts and ring ids exact, for 24, 64 and 128 rings
    (at 128, on merged multi-LiDAR scans whose tables pass 64 entries).
  * A valid point whose vertical angle is NaN: the oracle's and the XLA
    loop's ring table, which discover_rings_pallas does not give
    (ROADMAP queue 3, reference fault 5).
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from urban_road_filter_tpu.config import FilterConfig
from urban_road_filter_tpu.constants import STAR_KFI, STAR_REP
from urban_road_filter_tpu.io.multi_lidar import Extrinsics, merge_scans
from urban_road_filter_tpu.io.synthetic import (
    SCENES, SceneSpec, make_scan, make_sensor_scan)
from urban_road_filter_tpu.oracle import reference as oracle
from urban_road_filter_tpu.ops import geometry as jgeo
from urban_road_filter_tpu.ops.ingest_scan import (
    assign_rings_pallas, discover_rings_pallas, ingest_prep_pallas)
from urban_road_filter_torch import _build, pad_scan
from urban_road_filter_torch.ops import geometry as tgeo
from urban_road_filter_torch.ops import ingest

torch.set_num_threads(1)  # tier-1 runs several pytest workers

F32 = np.float32
N = 8192


def _t(a):
    return torch.from_numpy(np.array(a))


def _ulps(a, b):
    a = np.asarray(a, F32).view(np.int32).astype(np.int64)
    b = np.asarray(b, F32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _scan(scene="two_curbs", seed=3):
    return pad_scan(make_scan(SCENES[scene](), n_rings=24, n_azimuth=384,
                              seed=seed), N)


def _merged_scan(seed):
    """Two emulated OS1-64 at offset mounts, 64 firings each, merged (the
    multi-LiDAR rig of bench.py at a small size): more than 64 rings."""
    exts = [Extrinsics(x=0.4, y=0.3, z=0.0, yaw_deg=1.5),
            Extrinsics(x=-0.4, y=-0.3, z=-0.05, yaw_deg=-2.0)]
    return pad_scan(merge_scans(
        [make_sensor_scan(SceneSpec(), "os1_64", seed=seed + k, firings=64)
         for k in range(2)], exts), N)


def _adversarial():
    """tests/test_pallas_interpret.py's adversarial ingest rows (exact ROI
    bounds, the x+y+z == 0 drop, a near-2 pi azimuth, axis-aligned
    points), and an ROI point whose sector rounds to 360 (beam 0)."""
    pts, cfg = _scan(), FilterConfig()
    pts[0] = (cfg.max_x, 0.5, -0.5, 0)
    pts[1] = (cfg.min_x, -0.5, 0.5, 0)
    pts[2] = (1.0, 2.0, -3.0, 0)
    pts[3] = (40.0, -1e-6, 0.2, 0)
    pts[4] = (5.0, 0.0, 0.1, 0)
    pts[5] = (0.0, 5.0, 0.1, 0)
    pts[6] = (0.0, 0.0, 4.0, 0)
    pts[100] = (10.0, -1e-7, -1.5, 0)  # in the ROI; its sector rounds to 360
    return pts, cfg


def _batch(b):
    pts, cfg = _adversarial()
    ptsb = np.stack([pts] * b)
    if b > 1:
        ptsb[-1, 7:100] = 0  # vary the last scan's in-ROI count
    return ptsb, cfg


def _jax_alpha(pts, cfg):
    """(valid, vertical angle) of one scan from the JAX package (eager)."""
    x, y, z = (jnp.asarray(pts[:, i]) for i in range(3))
    valid = np.asarray(jgeo.roi_mask_xyz(x, y, z, cfg))
    return valid, np.asarray(jgeo.vertical_angles(x, y, z)[1])


class TestIngestPrep:
    @pytest.mark.parametrize("b", [1, 4])
    def test_matches_jax(self, b):
        ptsb, cfg = _batch(b)
        x, y, z = (np.ascontiguousarray(ptsb[..., i]) for i in range(3))
        valid, fk, r_key, piece = (t.numpy() for t in ingest.ingest_prep(
            _t(x), _t(y), _t(z), cfg))
        jx, jy, jz = map(jnp.asarray, (x, y, z))
        want_valid = np.asarray(jgeo.roi_mask_xyz(jx, jy, jz, cfg))
        np.testing.assert_array_equal(valid, want_valid)
        np.testing.assert_array_equal(piece, want_valid.sum(axis=1))
        assert piece.dtype == np.int32 and piece[0] > 30
        if b > 1:
            assert piece[-1] < piece[0]

        # r_key: exact against the eager XLA ops.
        want_r = np.where(want_valid, np.asarray(jnp.sqrt(jx * jx + jy * jy)),
                          np.inf)
        np.testing.assert_array_equal(r_key, want_r)

        # fk: exact against the oracle's binning (float64 atan2).
        fi = np.arctan2(y.astype(np.float64), x.astype(np.float64)).astype(F32)
        fi = np.where(fi < 0, (fi.astype(np.float64) + 2 * math.pi).astype(F32),
                      fi)
        want_fk = np.where(want_valid, (fi * STAR_KFI).astype(np.int32)
                           % STAR_REP, STAR_REP)
        np.testing.assert_array_equal(fk, want_fk)
        assert fk.dtype == np.int32 and fk[:, 100].tolist() == [0] * b
        assert int(fi[0, 100] * STAR_KFI) == STAR_REP

        # The interpreted Pallas kernel, fed the JAX package's f32 atan2.
        fi32 = jnp.arctan2(jy, jx)
        pv, pfk, prk, ppiece = (np.asarray(t) for t in ingest_prep_pallas(
            jx, jy, jz, fi32, cfg, interpret=True))
        np.testing.assert_array_equal(valid, pv)
        np.testing.assert_array_equal(piece, ppiece)
        assert _ulps(r_key, prk).max() <= 1
        # Only where the f32 and f64 atan2 round apart may the sectors
        # differ; the scene has such points, and a few of them change beam.
        apart = np.asarray(fi32) != np.arctan2(
            y.astype(np.float64), x.astype(np.float64)).astype(F32)
        moved = fk != pfk
        assert not (moved & ~apart).any()
        assert apart.sum() > 0 and moved.sum() <= apart.sum()

    def test_without_star_keys(self):
        ptsb, cfg = _batch(4)
        xyz = [_t(np.ascontiguousarray(ptsb[..., i])) for i in range(3)]
        v1, _, _, p1 = ingest.ingest_prep(*xyz, cfg)
        v2, fk, rk, p2 = ingest.ingest_prep(*xyz, cfg, want_star_keys=False)
        assert fk is None and rk is None
        assert torch.equal(v1, v2) and torch.equal(p1, p2)

    def test_rows_and_planar_views(self):
        # The (B, N) coordinate views of a rows batch are strided; the
        # planar ones contiguous.  Both give the same outputs.
        ptsb, cfg = _batch(4)
        rows = _t(ptsb)
        planar = _t(np.ascontiguousarray(ptsb[..., :3].transpose(2, 0, 1)))
        got_r = ingest.ingest_prep(rows[..., 0], rows[..., 1], rows[..., 2],
                                   cfg)
        got_p = ingest.ingest_prep(planar[0], planar[1], planar[2], cfg)
        for a, b in zip(got_r, got_p):
            assert torch.equal(a, b)


def _alphas(seeds, all_invalid=None, merged=False):
    """(valid, alpha) of one scan per seed, as (B, N) arrays; ``merged``
    takes multi-LiDAR scans (> 64 rings) instead of 24-ring ones."""
    cfg = FilterConfig()
    vs, als = [], []
    for seed in seeds:
        pts = _merged_scan(seed) if merged else _scan(seed=seed)
        if seed == all_invalid:
            pts[:] = 0
        v, a = _jax_alpha(pts, cfg)
        vs.append(v)
        als.append(a)
    return np.stack(vs), np.stack(als), cfg


class TestDiscoverRings:
    @pytest.mark.parametrize("rings", [24, 64, 128])
    def test_matches_jax(self, rings):
        seeds = (rings, rings + 5, rings + 6)
        valid, alpha, cfg = _alphas(seeds, all_invalid=rings + 6,
                                    merged=rings > 64)
        got_a, got_c = (t.numpy() for t in ingest.discover_rings(
            _t(alpha), _t(valid), cfg.interval, rings))
        assert got_a.shape == (3, rings) and got_c.dtype == np.int32
        for k in range(3):
            wa, wc = jgeo.discover_rings(jnp.asarray(alpha[k]),
                                         jnp.asarray(valid[k]), cfg.interval,
                                         rings=rings)
            np.testing.assert_array_equal(got_a[k], np.asarray(wa))
            assert got_c[k] == int(wc)
        assert got_c[0] > 20 and got_c[2] == 0
        assert np.isinf(got_a[2]).all()
        if rings > 64:  # the table outgrows 64 entries
            assert got_c[:2].min() > 64
        pa, pc = discover_rings_pallas(
            jnp.asarray(np.where(valid, alpha, np.nan)), cfg.interval, rings,
            interpret=True)
        np.testing.assert_array_equal(got_a, np.asarray(pa))
        np.testing.assert_array_equal(got_c, np.asarray(pc))

    def test_single_scan_is_the_batch_lane(self):
        valid, alpha, cfg = _alphas((1, 2))
        ba, bc = ingest.discover_rings(_t(alpha), _t(valid), cfg.interval)
        a, c = tgeo.discover_rings(_t(alpha[1]), _t(valid[1]), cfg.interval)
        assert a.shape == (64,) and c.shape == ()
        assert torch.equal(a, ba[1]) and torch.equal(c, bc[1])

    def test_more_than_128_rings_raise(self):
        valid, alpha, cfg = _alphas((1,))
        with pytest.raises(ValueError, match="at most 128"):
            ingest.discover_rings(_t(alpha), _t(valid), cfg.interval, 129)


class TestNanAlpha:
    """A point in the ROI whose coordinates are all below ~1e-23: x*x + y*y
    + z*z underflows to 0, so its vertical angle is NaN.  The ROI admits it
    when max_z >= 0."""

    def _inputs(self):
        cfg = FilterConfig(max_z=1.0)
        pts = _scan()
        pts[5] = (1e-25, 0.0, 0.0, 0)
        valid, alpha = _jax_alpha(pts, cfg)
        assert valid[5] and np.isnan(alpha[5])
        return pts, valid, alpha, cfg

    def test_follows_the_oracle(self):
        pts, valid, alpha, cfg = self._inputs()
        got_a, got_c = (t.numpy() for t in ingest.discover_rings(
            _t(alpha[None]), _t(valid[None]), cfg.interval, 64))
        # The oracle takes the NaN point again in every round after it.
        reps = oracle.discover_rings(alpha[valid], cfg.interval, channels=64)
        np.testing.assert_array_equal(got_a[0], np.sort(reps))
        assert got_c[0] == len(reps) == 64
        assert np.isnan(got_a[0]).sum() == 59
        wa, wc = jgeo.discover_rings(jnp.asarray(alpha), jnp.asarray(valid),
                                     cfg.interval, rings=64)
        np.testing.assert_array_equal(got_a[0], np.asarray(wa))
        assert int(wc) == 64
        # Only the 5 rings found before the NaN point bin anything; the
        # NaN point itself and every point off those rings are dropped.
        ring = ingest.assign_rings(_t(alpha[None]), _t(valid[None]),
                                   _t(got_a), cfg.interval).numpy()[0]
        np.testing.assert_array_equal(ring, np.asarray(jgeo.assign_rings(
            jnp.asarray(alpha), jnp.asarray(valid), wa, cfg.interval)))
        assert ring[5] == 64 and set(ring[valid]) <= {0, 1, 2, 3, 4, 64}

    def test_pallas_reads_nan_as_dropped(self):
        # Reference fault 5: the Pallas kernel reads the NaN point as a
        # dropped one and finds the scan's 23 real rings instead.
        _, valid, alpha, cfg = self._inputs()
        _, pc = discover_rings_pallas(
            jnp.asarray(np.where(valid, alpha, np.nan)[None]), cfg.interval,
            64, interpret=True)
        _, got_c = ingest.discover_rings(_t(alpha[None]), _t(valid[None]),
                                         cfg.interval, 64)
        assert int(pc[0]) == 23 != int(got_c[0])


class TestAssignRings:
    @pytest.mark.parametrize("rings", [24, 64, 128])
    def test_matches_pallas(self, rings):
        # A different ring table per scan, past 64 entries at 128 rings.
        valid, alpha, cfg = _alphas((rings, rings + 1, rings + 2),
                                    merged=rings > 64)
        tables = np.stack([np.asarray(jgeo.discover_rings(
            jnp.asarray(alpha[k]), jnp.asarray(valid[k]), cfg.interval,
            rings=rings)[0]) for k in range(3)])
        got = ingest.assign_rings(_t(alpha), _t(valid), _t(tables),
                                  cfg.interval).numpy()
        want = np.asarray(assign_rings_pallas(
            jnp.asarray(np.where(valid, alpha, np.nan)), jnp.asarray(tables),
            cfg.interval, interpret=True))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32
        assert (got[~valid] == rings).all() and (got[valid] < rings).any()
        if rings > 64:
            assert got[valid].max() >= 64
        for k in range(3):
            np.testing.assert_array_equal(got[k], np.asarray(jgeo.assign_rings(
                jnp.asarray(alpha[k]), jnp.asarray(valid[k]),
                jnp.asarray(tables[k]), cfg.interval)))
        one = tgeo.assign_rings(_t(alpha[1]), _t(valid[1]), _t(tables[1]),
                                cfg.interval)
        np.testing.assert_array_equal(one.numpy(), got[1])

    def test_empty_table(self):
        alpha = np.full((2, 512), 30.0, F32)
        valid = np.ones((2, 512), bool)
        table = np.full((2, 24), np.inf, F32)
        got = ingest.assign_rings(_t(alpha), _t(valid), _t(table), 0.18)
        assert (got.numpy() == 24).all()
        want = assign_rings_pallas(jnp.asarray(alpha), jnp.asarray(table),
                                   0.18, interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_ingest_launches_no_kernel():
    ptsb, cfg = _batch(2)
    xyz = [_t(np.ascontiguousarray(ptsb[..., i])) for i in range(3)]
    _build.reset_launch_counts()
    valid, _, _, _ = ingest.ingest_prep(*xyz, cfg)
    _, alpha = tgeo.vertical_angles(*xyz)
    angles, _ = ingest.discover_rings(alpha, valid, cfg.interval)
    ingest.assign_rings(alpha, valid, angles, cfg.interval)
    assert not any(_build.launch_counts().values())
