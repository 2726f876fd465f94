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
  * The rules the CUDA kernels rest on (csrc/ingest.cu), as numpy models:
    K2's prefix -> filter -> finish decomposition of the greedy (for a
    prefix of 0, 1, 7, 4096 and all points) and K3's bisection of the
    sorted table, exact against the twins and the eager JAX ops on the
    inputs that stress them, and in property tests.
"""

import math

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

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


def _k1_views(ptsb, layout):
    """(x, y, z) (B, N) views of (B, N, 4) rows in one of the layouts K1
    takes: rows of 4 floats, rows of 3, rows of 4 at a storage offset of
    one float, or planes."""
    b, n, _ = ptsb.shape
    if layout == "planar":
        xyz = _t(np.ascontiguousarray(ptsb[..., :3].transpose(2, 0, 1)))
        return xyz[0], xyz[1], xyz[2]
    if layout == "rows3":
        rows = _t(np.ascontiguousarray(ptsb[..., :3]))
    elif layout == "offset1":
        flat = torch.zeros(1 + ptsb.size)
        flat[1:] = _t(ptsb).flatten()
        rows = flat[1:].view(b, n, 4)
        assert rows.storage_offset() == 1
    else:
        rows = _t(ptsb)
    return rows[..., 0], rows[..., 1], rows[..., 2]


class TestIngestPrepLayouts:
    """K1's twin on every layout the kernel reads in its own way (rows of
    4 floats a float4 per point, planes a float4 per plane, other strides
    point by point), at point counts that leave a ragged tail, against the
    interpreted Pallas kernel (its streams zero-padded to the 128-point
    multiple it needs: zero points are outside the ROI)."""

    @pytest.mark.parametrize("n", [3, 4097])
    @pytest.mark.parametrize("layout", ["rows", "rows3", "offset1",
                                        "planar"])
    def test_matches_pallas(self, n, layout):
        ptsb, cfg = _batch(2)
        ptsb = np.ascontiguousarray(ptsb[:, :n])
        valid, fk, r_key, piece = (t.numpy() for t in ingest.ingest_prep(
            *_k1_views(ptsb, layout), cfg))
        pad = -n % 128
        jx, jy, jz = (jnp.asarray(np.pad(ptsb[..., i], ((0, 0), (0, pad))))
                      for i in range(3))
        pv, pfk, prk, ppiece = (np.asarray(t) for t in ingest_prep_pallas(
            jx, jy, jz, jnp.arctan2(jy, jx), cfg, interpret=True))
        pv, pfk, prk = pv[:, :n], pfk[:, :n], prk[:, :n]
        np.testing.assert_array_equal(valid, pv)
        np.testing.assert_array_equal(piece, ppiece)
        assert valid[0].sum() > 0 or n == 3
        # r_key: exact against the eager XLA ops, within 1 ulp of the
        # interpreted kernel (it contracts x*x + y*y into a multiply-add).
        x, y = ptsb[..., 0], ptsb[..., 1]
        want_r = np.where(pv, np.asarray(jnp.sqrt(jnp.asarray(x * x)
                                                  + jnp.asarray(y * y))),
                          np.inf)
        np.testing.assert_array_equal(r_key, want_r)
        assert _ulps(r_key, prk).max() <= 1
        # fk: exact wherever the f32 and f64 atan2 round alike.
        fi32 = np.asarray(jnp.arctan2(jnp.asarray(y), jnp.asarray(x)))
        same = fi32 == np.arctan2(y.astype(np.float64),
                                  x.astype(np.float64)).astype(F32)
        np.testing.assert_array_equal(fk[same], pfk[same])
        assert (fk[~valid] == STAR_REP).all()

    @pytest.mark.parametrize("n", [3, 4097])
    def test_layouts_agree(self, n):
        ptsb, cfg = _batch(3)
        ptsb = np.ascontiguousarray(ptsb[:, :n])
        want = ingest.ingest_prep(*_k1_views(ptsb, "rows"), cfg)
        for layout in ("rows3", "offset1", "planar"):
            got = ingest.ingest_prep(*_k1_views(ptsb, layout), cfg)
            for g, w in zip(got, want):
                assert torch.equal(g, w), layout


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


class _Stream:
    """A stand-in for torch.cuda.Stream: a handle and whether it is idle."""

    def __init__(self, handle, idle=True):
        self.cuda_stream, self.idle = handle, idle

    def query(self):
        return self.idle


@pytest.mark.parametrize("kernel", _build.TICKETED)
def test_ticketed_launches_keep_to_one_busy_stream(monkeypatch, kernel):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(_build, "_last_stream", {})
    dev = torch.device("cuda", 0)
    first, second = _Stream(1, idle=False), _Stream(2)
    _build._one_stream(kernel, dev, first)
    _build._one_stream(kernel, dev, first)  # the same stream, still busy
    with pytest.raises(RuntimeError, match="two streams at once"):
        _build._one_stream(kernel, dev, second)
    first.idle = True
    _build._one_stream(kernel, dev, second)
    # Another device, or another ticketed kernel, keeps its own record.
    _build._one_stream(kernel, torch.device("cuda", 1), _Stream(3, False))
    other = [k for k in _build.TICKETED if k != kernel][0]
    _build._one_stream(other, dev, _Stream(4, idle=False))
    _build._one_stream(kernel, dev, _Stream(5))
    # Inside a capture the earlier stream is not queried.
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    _build._one_stream(kernel, dev, _Stream(6, idle=False))
    _build._one_stream(kernel, dev, _Stream(7))


# --- The rules K2 and K3 rest on (csrc/ingest.cu), as numpy models ---------

CHUNK = 4096  # the kernel's prefix P and its chunk of 1024 threads x 4


def _matches(a, t, tol):
    """|fl(a - t)| <= tol in float32 (NaN matches nothing)."""
    with np.errstate(invalid="ignore"):
        return np.abs(np.float32(a) - np.float32(t)) <= tol


def _first_match(alpha, table, tol):
    """K3's search: over the sorted table padded with +inf to a power of
    two above its size, lo = the number of leading entries with fl(a - t)
    > tol; the first match is lo when |fl(a - t_lo)| <= tol, else none
    (len(table))."""
    rings = len(table)
    size = 1
    while size <= rings:
        size <<= 1
    t = np.full(size, np.inf, F32)
    t[:rings] = table
    lo = np.zeros(np.shape(alpha), np.int64)
    step = size >> 1
    with np.errstate(invalid="ignore"):
        while step:
            lo = np.where(alpha - t[lo + step - 1] > tol, lo + step, lo)
            step >>= 1
    hit = (lo < rings) & _matches(alpha, t[lo], tol)
    return np.where(hit, lo, rings)


def _greedy(alpha, open_, table, rings, tol, chunk, tested):
    """A chunked greedy of the kernel's kind over alpha in input order,
    extending ``table`` (a list) in place.  open_: the points open against
    table[:tested].  Each round resolves the chunk's first 32 open points
    in order, each a ring unless it matches a ring found before it, and
    drops the chunk's points that match the round's rings; a ring that does
    not match itself (NaN) fills the table."""
    for base in range(0, len(alpha), chunk):
        if len(table) >= rings:
            return
        a = alpha[base:base + chunk]
        o = open_[base:base + chunk].copy()
        for t in table[tested:]:
            o &= ~_matches(a, t, tol)
        while len(table) < rings and o.any():
            k_round = len(table)
            cand = np.flatnonzero(o)[:32]
            todo = np.ones(len(cand), bool)
            for c, r in enumerate(cand):
                if not todo[c] or len(table) >= rings:
                    continue
                table.append(a[r])
                if not _matches(a[r], a[r], tol):
                    table.extend([a[r]] * (rings - len(table)))
                    break
                todo &= ~_matches(a[cand], a[r], tol)
            for t in table[k_round:]:
                o &= ~_matches(a, t, tol)


def _sorted(values):
    """torch.sort's order (NaN last), bit patterns kept (numpy's own sort
    may canonicalise NaNs)."""
    values = np.asarray(values, F32)
    return values[np.argsort(values, kind="stable")]


def _discover_model(alpha, valid, interval, rings, p, chunk=CHUNK):
    """K2: the greedy over the first p points (the table T), the later
    points that match no entry of sorted T (the filter, by K3's search),
    then the greedy from T over those alone, in input order; the table
    sorted as torch.sort sorts it (NaN last)."""
    tol = F32(interval)
    table = []
    _greedy(alpha[:p], valid[:p], table, rings, tol, chunk, 0)
    k_t = len(table)
    if k_t < rings:
        srt = _sorted(table)
        open_ = valid[p:] & (_first_match(alpha[p:], srt, tol) == k_t)
        _greedy(alpha[p:], open_, table, rings, tol, chunk, k_t)
    k = len(table)
    angles = np.concatenate([np.asarray(table, F32),
                             np.full(rings - k, np.inf, F32)])
    return _sorted(angles), k


def _bits(a):
    return np.asarray(a, F32).view(np.int32)


def _check_discover(alpha, valid, interval, rings, chunks=(CHUNK,)):
    """The twin, the eager JAX op and the model (every prefix) agree bit
    for bit; returns the twin's (angles, count)."""
    got_a, got_c = (t.numpy()[0] for t in ingest.discover_rings(
        _t(alpha[None]), _t(valid[None]), interval, rings))
    wa, wc = jgeo.discover_rings(jnp.asarray(alpha), jnp.asarray(valid),
                                 interval, rings=rings)
    np.testing.assert_array_equal(_bits(got_a), _bits(wa))
    assert int(got_c) == int(wc)
    for chunk in chunks:
        for p in (0, 1, 7, CHUNK, len(alpha)):
            ma, mc = _discover_model(alpha, valid, interval, rings, p, chunk)
            np.testing.assert_array_equal(_bits(ma), _bits(got_a),
                                          err_msg=f"prefix {p}")
            assert mc == int(got_c), (p, chunk)
    return got_a, int(got_c)


def _check_assign(alpha, valid, table, interval):
    """The twin, the eager JAX op and the bisection model agree."""
    got = ingest.assign_rings(_t(alpha[None]), _t(valid[None]),
                              _t(table[None]), interval).numpy()[0]
    want = np.asarray(jgeo.assign_rings(jnp.asarray(alpha),
                                        jnp.asarray(valid),
                                        jnp.asarray(table), interval))
    np.testing.assert_array_equal(got, want)
    model = np.where(valid, _first_match(alpha, table, F32(interval)),
                     len(table))
    np.testing.assert_array_equal(model, got)
    return got


def _scan64(ring_major=False, n_azimuth=128, seed=3):
    """(valid, alpha) of a 64-ring scan (azimuth-major as the sensor emits
    it, or reordered ring-major: the kernel's worst case, whose prefix
    holds about 2 rings)."""
    pts = make_scan(SCENES["two_curbs"](), n_rings=64, n_azimuth=n_azimuth,
                    seed=seed)
    if ring_major:
        pts = np.ascontiguousarray(
            pts.reshape(n_azimuth, 64, 4).transpose(1, 0, 2).reshape(-1, 4))
    return _jax_alpha(pts, FilterConfig())


def _nan_scan(where):
    """A 64-ring scan (12288 points) with valid NaN-angle points at the
    given indices (FilterConfig(max_z=1.0) admits them)."""
    cfg = FilterConfig(max_z=1.0)
    pts = make_scan(SCENES["two_curbs"](), n_rings=64, n_azimuth=192, seed=4)
    for i in where:
        pts[i] = (1e-25, 0.0, 0.0, 0)
    valid, alpha = _jax_alpha(pts, cfg)
    assert all(valid[i] and np.isnan(alpha[i]) for i in where)
    return valid, alpha, cfg


def _tol_stream(tol, centres):
    """Points exactly tol from each centre, and one ulp either side."""
    tol = F32(tol)
    pts = []
    for c in np.asarray(centres, F32):
        for edge in (c + tol, c - tol):
            e = F32(edge)
            pts += [c, e, np.nextafter(e, F32(np.inf)),
                    np.nextafter(e, F32(-np.inf))]
    return np.asarray(pts, F32)


class TestDiscoverRule:
    """K2's decomposition: prefix greedy, filter against its table T, the
    greedy from T over the points left open."""

    @pytest.mark.parametrize("ring_major", [False, True])
    def test_scan_orders(self, ring_major):
        # At 64 rings x 2048 azimuths (131072 points) the ring-major
        # order's prefix holds its first two rings only.
        valid, alpha = _scan64(ring_major, n_azimuth=2048)
        _, count = _check_discover(alpha, valid, 0.18, 64)
        assert count > 40
        table = []
        _greedy(alpha[:CHUNK], valid[:CHUNK], table, 64, F32(0.18), CHUNK, 0)
        assert len(table) <= 2 if ring_major else len(table) == count

    @pytest.mark.parametrize("where", [(5,), (5000,), (5, 5000)])
    def test_nan_angles_inside_and_after_the_prefix(self, where):
        valid, alpha, cfg = _nan_scan(where)
        angles, count = _check_discover(alpha, valid, cfg.interval, 64)
        assert count == 64 and np.isnan(angles[-1])
        # The NaN point takes every round after it: the rings found before
        # it are the only finite entries.
        tol = F32(cfg.interval)
        first = min(where)
        before, _ = _discover_model(alpha[:first], valid[:first],
                                    cfg.interval, 64, 0)
        n_before = int(np.isfinite(before).sum())
        assert int(np.isfinite(angles).sum()) == n_before
        assert n_before < 64 and _matches(alpha[first], alpha[first],
                                          tol) is np.False_

    def test_cap_reached_in_the_prefix(self):
        valid, alpha = _scan64()
        angles, count = _check_discover(alpha, valid, 0.18, 24)
        assert count == 24 and np.isfinite(angles).all()
        table = []
        _greedy(alpha[:CHUNK], valid[:CHUNK], table, 24, F32(0.18), CHUNK, 0)
        assert len(table) == 24

    @pytest.mark.parametrize("n", [1000, 8189, 8191])
    def test_short_and_ragged_scans(self, n):
        # n < P; n not a multiple of 32 or 4.
        valid, alpha = _scan64()
        _, count = _check_discover(alpha[:n], valid[:n], 0.18, 64)
        assert count > 20

    @pytest.mark.parametrize("n", [4097, 8189])
    def test_one_valid_point_at_the_last_index(self, n):
        _, alpha = _scan64()
        valid = np.zeros(n, bool)
        valid[-1] = True
        angles, count = _check_discover(alpha[:n], valid, 0.18, 64)
        assert count == 1 and angles[0] == alpha[n - 1]
        assert np.isinf(angles[1:]).all()

    def test_no_valid_point(self):
        _, alpha = _scan64()
        angles, count = _check_discover(alpha, np.zeros(len(alpha), bool),
                                        0.18, 64)
        assert count == 0 and np.isposinf(angles).all()

    @pytest.mark.parametrize("tol", [0.18, 0.25])
    def test_points_exactly_tol_apart(self, tol):
        # A ring, then points exactly tol from it (matched) and one ulp
        # further (new rings), past the prefix as well as inside it.
        stream = _tol_stream(tol, [-10.0, 0.0, 10.0])
        alpha = np.concatenate([stream, np.full(CHUNK, -30.0, F32), stream,
                                -stream])
        valid = np.ones(len(alpha), bool)
        valid[len(stream):len(stream) + CHUNK:2] = False
        _, count = _check_discover(alpha, valid, tol, 128,
                                   chunks=(CHUNK, 32))
        assert count > 8

    def test_rule_is_the_greedy_at_any_chunk(self):
        valid, alpha = _scan64(True)
        for chunk in (32, 96, 1024):
            got, _ = _discover_model(alpha, valid, 0.18, 64, 100, chunk)
            want, _ = _discover_model(alpha, valid, 0.18, 64, 0, CHUNK)
            np.testing.assert_array_equal(_bits(got), _bits(want))


class TestAssignRule:
    """K3's bisection of the sorted table equals the first match."""

    @pytest.mark.parametrize("rings", [24, 64, 128])
    def test_discovered_tables(self, rings):
        valid, alpha, cfg = _alphas((rings, rings + 1), merged=rings > 64)
        for k in range(2):
            table = np.asarray(jgeo.discover_rings(
                jnp.asarray(alpha[k]), jnp.asarray(valid[k]), cfg.interval,
                rings=rings)[0])
            got = _check_assign(alpha[k], valid[k], table, cfg.interval)
            assert (got[valid[k]] < rings).any()

    @pytest.mark.parametrize("tol", [0.18, 0.25])
    def test_entries_exactly_tol_away(self, tol):
        table = np.concatenate([np.asarray([-10.0, 0.0, 10.0], F32),
                                np.full(61, np.inf, F32)])
        alpha = _tol_stream(tol, [-10.0, 0.0, 10.0])
        alpha = np.concatenate([alpha, -alpha, alpha + F32(0.5)])
        got = _check_assign(alpha, np.ones(len(alpha), bool), table, tol)
        assert (got < 3).any() and (got == 64).any()
        # From the entry 0.0: exactly tol away matches, one ulp further
        # does not, one ulp nearer does.
        assert got[9] == 1 and got[10] == 64 and got[11] == 1

    def test_nan_tables(self):
        # A table whose later entries are NaN (a NaN-angle ring) and an
        # all-NaN table; NaN alphas match nothing.
        _, alpha = _scan64()
        alpha = alpha.copy()
        alpha[::97] = np.nan
        valid = np.ones(len(alpha), bool)
        part = _sorted(np.concatenate([alpha[1:6], np.full(59, np.nan, F32)]))
        got = _check_assign(alpha, valid, part, 0.18)
        assert (got < 5).any() and (got[::97] == 64).all()
        got = _check_assign(alpha, valid, np.full(64, np.nan, F32), 0.18)
        assert (got == 64).all()

    @pytest.mark.parametrize("rings", [1, 24])
    def test_empty_tables(self, rings):
        _, alpha = _scan64()
        got = _check_assign(alpha, np.ones(len(alpha), bool),
                            np.full(rings, np.inf, F32), 0.18)
        assert (got == rings).all()

    def test_ragged_and_invalid(self):
        valid, alpha = _scan64()
        table, _ = _discover_model(alpha, valid, 0.18, 64, CHUNK)
        got = _check_assign(alpha[:8189], valid[:8189], table, 0.18)
        assert (got[~valid[:8189]] == 64).all()


@st.composite
def _clustered(draw):
    """A small scan: a few angle clusters (ring angles with a little
    spread), some NaN angles and invalid points, in a random order."""
    n = draw(st.sampled_from([37, 64, 200]))
    rng = np.random.default_rng(draw(st.integers(0, 2 ** 32 - 1)))
    centres = rng.uniform(-25.0, 5.0, draw(st.integers(1, 6)))
    spread = draw(st.sampled_from([0.0, 0.05, 0.2]))
    alpha = (centres[rng.integers(0, len(centres), n)]
             + rng.normal(0.0, spread, n)).astype(F32)
    alpha[rng.random(n) < draw(st.sampled_from([0.0, 0.02]))] = np.nan
    valid = rng.random(n) < draw(st.sampled_from([1.0, 0.7]))
    return alpha, valid


@settings(max_examples=40, deadline=None, database=None, derandomize=True)
@given(_clustered(), st.sampled_from([0.18, 0.25, 0.0, -0.1]),
       st.sampled_from([1, 4, 16]), st.sampled_from([32, 64, CHUNK]))
def test_discover_rule_property(scan, interval, rings, chunk):
    alpha, valid = scan
    _check_discover(alpha, valid, interval, rings, chunks=(chunk,))


@settings(max_examples=40, deadline=None, database=None, derandomize=True)
@given(_clustered(), st.sampled_from([0.18, 0.25, 0.0]),
       st.sampled_from([1, 4, 16]))
def test_assign_rule_property(scan, interval, rings):
    alpha, valid = scan
    table = np.asarray(jgeo.discover_rings(
        jnp.asarray(alpha), jnp.asarray(valid), interval, rings=rings)[0])
    _check_assign(alpha, valid, table, interval)


# --- The thresholds as 0-d tensors (the device parameter buffer's form) ---

@pytest.mark.parametrize("kw", [dict(), dict(min_x=1.0, max_x=25.0,
                                             min_y=-8.0, max_y=8.0,
                                             min_z=-2.8, max_z=-1.2),
                                dict(interval=0.3)])
def test_twins_take_a_bound_config(kw):
    """K1-K3's twins give the same bits under a configuration bound to a
    parameter buffer (0-d tensor fields, config.device_config) as under
    its host floats."""
    from urban_road_filter_torch.config import FilterConfig as TConfig
    from urban_road_filter_torch.config import device_config

    cfg = TConfig(**kw)
    bound = device_config(cfg, "cpu")
    assert isinstance(bound.min_x, torch.Tensor)
    pts = _t(_scan())
    x, y, z = (pts[None, :, i].contiguous() for i in range(3))
    got = ingest.ingest_prep_plain(x, y, z, bound)
    want = ingest.ingest_prep_plain(x, y, z, cfg)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    _, alpha = tgeo.vertical_angles(x, y, z)
    angles, count = ingest.discover_rings_plain(alpha, got[0],
                                                bound.interval, 64)
    w_angles, w_count = ingest.discover_rings_plain(alpha, got[0],
                                                    cfg.interval, 64)
    assert torch.equal(angles.view(torch.int32), w_angles.view(torch.int32))
    assert torch.equal(count, w_count)
    assert torch.equal(
        ingest.assign_rings_plain(alpha, got[0], angles, bound.interval),
        ingest.assign_rings_plain(alpha, got[0], angles, cfg.interval))


@pytest.mark.parametrize("tol", [0.18, 0.3, 0.5])
def test_ring_twins_take_interval_as_tensor(tol):
    """K2's and K3's twins with the interval as a 0-d tensor on points
    exactly tol from a ring and one ulp either side."""
    centres = np.linspace(-20.0, 20.0, 41).astype(F32)
    alpha = _t(_tol_stream(tol, centres))[None]
    valid = torch.ones_like(alpha, dtype=torch.bool)
    t = torch.tensor(F32(tol))
    angles, count = ingest.discover_rings_plain(alpha, valid, t, 128)
    w_angles, w_count = ingest.discover_rings_plain(alpha, valid, tol, 128)
    assert torch.equal(angles.view(torch.int32), w_angles.view(torch.int32))
    assert torch.equal(count, w_count)
    assert torch.equal(ingest.assign_rings_plain(alpha, valid, angles, t),
                       ingest.assign_rings_plain(alpha, valid, angles, tol))
