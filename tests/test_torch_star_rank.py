"""Numpy models of the designs of K4 (the star search, csrc/star.cu) and K5
(the stable group rank, csrc/group_place.cu), held against the plain
versions, the numpy oracle and the JAX package on the CPU.

K4: the partition by beam without a sort (each block lays its beams out in
a region of its own and publishes a run per beam; keys and (r, z)
scattered in any order inside a run; a beam is its runs down a column of
the run table), the order of each beam by its 64-bit key (order(r) << 32 |
index), the selection of the next chunk of smallest keys above the last one
walked (by bisection when the rest of the bucket outgrows the chunk), and
the split walk (the off-chain values of 32 steps at once, the two
recurrences serial), against ops/star.py's star_search_plain (two stable
torch.sorts, then the plain walk) and the oracle's _beam_walk.  K5: per-tile
histograms, each group's column scanned in 32 slices of tiles, the ordered
pass of the warps of a tile, against _xla_rank and a direct
count.  Every comparison is exact: the models and the kernels round every
f32 operation as the reference does, and ranks are integers.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from star_streams import scatter_streams, walk_streams
from urban_road_filter_tpu.config import FilterConfig
from urban_road_filter_tpu.oracle import reference as oracle
from urban_road_filter_tpu.ops.rank import _xla_rank
from urban_road_filter_torch.ops import star as tstar
from urban_road_filter_torch.ops.rank import group_positions

torch.set_num_threads(1)  # tier-1 runs several pytest workers

F32 = np.float32
I32 = np.int32
BEAMS = 360
CHUNK = 1024  # csrc/star.cu kChunk
THREADS = 256  # csrc/star.cu kThreads
TILE = 1024  # csrc/group_place.cu kBlock


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- K4 model

def order_bits(r):
    """csrc/star.cu order_bits: unsigned images that order like torch.sort
    (-0.0 == +0.0, every NaN last and equal)."""
    r = np.asarray(r, F32)
    u = r.view(np.uint32).copy()
    u[r == 0] = 0
    out = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)
    out[np.isnan(r)] = 0xFFFFFFFF
    return out


def partition_model(fk, r, z, grid=BEAMS, seed=0):
    """Phase 1: block g takes the points grid-stride and owns the region
    [g * cap, (g + 1) * cap); it lays its beams out one after the other
    there, publishes each beam's run (start, count) in row g of the run
    table, and scatters its beam points' keys and (r, z) into their runs
    in a random order.  Returns (keys, rz, runs)."""
    rng = np.random.default_rng(seed)
    n = fk.size
    cap = THREADS * -(-n // (THREADS * grid))
    blk = (np.arange(n) // THREADS) % grid
    inb = (fk >= 0) & (fk < BEAMS)
    keys = np.zeros(grid * cap, np.uint64)
    rz = np.zeros((grid * cap, 2), F32)
    runs = np.zeros((grid, BEAMS, 2), np.int64)
    bits = order_bits(r).astype(np.uint64) << np.uint64(32)
    for g in range(grid):
        mine = np.flatnonzero(inb & (blk == g))
        assert mine.size <= cap
        cnt = np.bincount(fk[mine], minlength=BEAMS)
        loc = np.cumsum(cnt) - cnt
        runs[g, :, 0] = g * cap + loc
        runs[g, :, 1] = cnt
        cursor = np.zeros(BEAMS, np.int64)
        for i in rng.permutation(mine):
            at = g * cap + loc[fk[i]] + cursor[fk[i]]
            cursor[fk[i]] += 1
            keys[at] = bits[i] | np.uint64(i)
            rz[at] = r[i], z[i]
    return keys, rz, runs


def beam_elements(runs, b):
    """Phase 2: the scratch positions of beam b's elements e = 0, 1, ...,
    run after run down column b of the run table (what run_pos finds by
    bisection over the runs' exclusive offsets)."""
    return np.concatenate([np.arange(s, s + c) for s, c in runs[:, b]]
                          + [np.zeros(0, np.int64)])


def select_model(bucket, lo, chunk):
    """The next chunk of smallest keys >= lo, sorted: all of them when they
    fit, else those <= the least hi with chunk keys in [lo, hi], found by
    bisection over the key range as the kernel does."""
    rest = bucket[bucket >= lo]
    hi = np.uint64(2**64 - 1)
    if rest.size > chunk:
        l2, h2 = int(lo), 2**64 - 1
        while l2 < h2:
            mid = l2 + (h2 - l2) // 2
            if np.count_nonzero(rest <= np.uint64(mid)) >= chunk:
                h2 = mid
            else:
                l2 = mid + 1
        hi = np.uint64(h2)
    return np.sort(rest[rest <= hi])


def walk_model(bucket, brz, cfg, chunk=CHUNK):
    """Phase 3 on one bucket: passes of at most ``chunk`` keys, each walked
    32 steps at a time with the off-chain values computed for all 32 steps
    at once and the two recurrences serial.  Returns hp of the beam."""
    slope, kdev, kdist = F32(cfg.slope_param), F32(cfg.kdev_param), F32(
        cfg.kdist_param)
    dmin = int(cfg.dmin_param)
    n = bucket.size
    avg = dev = px = pz = F32(0)
    nan = 0
    walked, lo = 0, np.uint64(0)
    while n >= 2 and walked < n:
        srt = select_model(bucket, lo, chunk)
        m = srt.size
        assert m == min(chunk, n - walked)
        idx = (srt & np.uint64(0xFFFFFFFF)).astype(np.int64)
        # Each selected key carries its (r, z) from the scatter.
        where = np.searchsorted(bucket, srt, sorter=np.argsort(bucket))
        sel = np.argsort(bucket)[where]
        rs, zs = brz[sel, 0], brz[sel, 1]
        for c0 in range(0, m, 32):
            e = np.arange(c0, min(c0 + 32, m))
            i = walked + e
            bx, bz = rs[e], zs[e]
            ax = np.concatenate([[px], bx[:-1]]).astype(F32)
            az = np.concatenate([[pz], bz[:-1]]).astype(F32)
            step = i >= 1
            with np.errstate(all="ignore"):
                slp = (bz - az) / (bx - ax)
                isn = step & np.isnan(slp)
                mf = i.astype(F32) - (nan + np.cumsum(isn)).astype(F32)
                mm1, inv = mf - F32(1), F32(1) / mf
                ss, t1 = slp * slp, (bx - ax) * kdist
                ctrip = step & (slp > slope)
            upd = step & ~isn
            adapt = upd & (i > dmin)
            kmax = int(np.argmax(ctrip)) + 1 if ctrip.any() else e.size
            trips = ctrip.copy()
            a, d = avg, dev
            with np.errstate(all="ignore"):
                for k in range(kmax):  # the serial chain
                    if upd[k]:
                        a = (a * mm1[k] + slp[k]) * inv[k]
                        d = (d * mm1[k] + np.abs(slp[k] - a)) * inv[k]
                    if adapt[k] and (ss[k] - a * a) * kdev * t1[k] > d:
                        trips[k] = True
            if trips.any():
                return int(idx[e[np.argmax(trips)]]) + 1
            avg, dev, nan = a, d, nan + int(isn.sum())
            px, pz = bx[-1], bz[-1]
        walked += m
        lo = srt[-1] + np.uint64(1)
    return 0


def star_model(fk, r, z, cfg, chunk=CHUNK, seed=0):
    keys, rz, runs = partition_model(fk, r, z, seed=seed)
    hp = np.zeros(BEAMS, I32)
    for b in range(BEAMS):
        at = beam_elements(runs, b)
        bucket = keys[at]
        # The bucket's key order is exactly the stable radius order.
        idx = (np.sort(bucket) & np.uint64(0xFFFFFFFF)).astype(np.int64)
        mine = np.flatnonzero(fk == b)
        np.testing.assert_array_equal(idx, mine[torch.from_numpy(
            r[mine]).sort(stable=True).indices.numpy()])
        hp[b] = walk_model(bucket, rz[at], cfg, chunk)
    return hp


def oracle_hp(fk, r, z, cfg):
    """The oracle's walk on each beam in stable radius order."""
    hp = np.zeros(BEAMS, I32)
    for b in range(BEAMS):
        ids = np.flatnonzero(fk == b)
        if ids.size <= 1:
            continue
        ids = ids[np.argsort(r[ids], kind="stable")]
        i = oracle._beam_walk(r[ids], z[ids], F32(cfg.slope_param),
                              F32(cfg.kdev_param), F32(cfg.kdist_param),
                              int(cfg.dmin_param))
        if i >= 0:
            hp[b] = ids[i] + 1
    return hp


def _check(fk, r, z, cfg, chunk=CHUNK, with_oracle=True):
    want = tstar.star_search_plain(_t(fk), _t(r), _t(z), cfg).numpy()
    np.testing.assert_array_equal(star_model(fk, r, z, cfg, chunk), want)
    if with_oracle:
        np.testing.assert_array_equal(oracle_hp(fk, r, z, cfg), want)
    return want


def _scattered(seed, max_len=300):
    (fk, r, z), _ = scatter_streams(walk_streams(seed, max_len), seed)
    return fk, r, z


class TestStarModel:
    @pytest.mark.parametrize("seed,kw", [
        (0, dict()), (1, dict(curb_slope_deg=20.0)),
        (2, dict(kdev_param=0.6, dmin_param=3)),
        (3, dict(kdist_param=9.0, dmin_param=30))])
    def test_adversarial_streams(self, seed, kw):
        # NaN slopes (equal radii and z), inf slopes, radius ties, empty
        # and one-point beams, curb steps, a sink at +inf.
        hp = _check(*_scattered(seed), FilterConfig(**kw))
        assert 30 < np.count_nonzero(hp) < 358

    @pytest.mark.parametrize("chunk", [32, 64, 100])
    def test_beams_longer_than_the_chunk(self, chunk):
        # Every pass past the first takes its keys by bisection.
        fk, r, z = _scattered(4, 120)
        cfg = FilterConfig(kdev_param=5.0, kdist_param=0.4, dmin_param=30,
                           curb_slope_deg=89.0)
        _check(fk, r, z, cfg, chunk)

    def test_every_point_in_one_beam(self):
        fk, r, z = _scattered(5, 40)
        fk = np.where(fk < BEAMS, 17, fk).astype(I32)
        for chunk in (CHUNK, 50):
            _check(fk, r, z, FilterConfig(), chunk)

    def test_sink_only_and_empty(self):
        fk, r, z = _scattered(6, 20)
        sink = np.full_like(fk, BEAMS)
        assert not _check(sink, r, z, FilterConfig()).any()
        empty = np.zeros(0, I32), np.zeros(0, F32), np.zeros(0, F32)
        assert not _check(*empty, FilterConfig()).any()

    def test_one_point_beams_never_trip(self):
        fk = np.arange(BEAMS + 40, dtype=I32) % (BEAMS + 1)
        fk[BEAMS:] = BEAMS
        rng = np.random.default_rng(7)
        r = rng.uniform(1, 20, fk.size).astype(F32)
        z = rng.normal(size=fk.size).astype(F32)
        assert not _check(fk, r, z, FilterConfig()).any()

    def test_ties_keep_input_order(self):
        # Whole beams at one radius: every slope is +-inf or NaN, so the
        # first point whose z rises trips; input order decides which.
        rng = np.random.default_rng(8)
        fk = rng.integers(0, BEAMS + 1, 4000).astype(I32)
        r = rng.choice(np.array([2.0, 3.0], F32), fk.size)
        z = rng.choice(np.array([0.0, 0.1, -0.1], F32), fk.size)
        hp = _check(fk, r, z, FilterConfig())
        assert np.count_nonzero(hp) > 100

    def test_order_bits_order_like_torch_sort(self):
        # The kernel's key order is torch.sort's stable order for every
        # float: -0.0 equal to +0.0, NaNs (either sign) last.  In-beam radii
        # from K1 are finite and >= +0, where the key is the IEEE bits with
        # the sign bit set, so they order like the values.
        rng = np.random.default_rng(9)
        pool = np.array([-0.0, 0.0, np.nan, -np.nan, np.inf, -np.inf, 1.5,
                         -1.5, 1e-45, -1e-45, 3e38], F32)
        r = np.concatenate([pool, rng.choice(pool, 500),
                            rng.normal(size=500).astype(F32)])
        key = order_bits(r).astype(np.uint64) << np.uint64(32) | np.arange(
            r.size, dtype=np.uint64)
        np.testing.assert_array_equal(
            np.argsort(key), torch.from_numpy(r).sort(stable=True).indices)
        finite = np.abs(rng.normal(size=1000)).astype(F32)
        finite[:3] = [0.0, 1e-45, 3e38]
        np.testing.assert_array_equal(
            order_bits(finite), finite.view(np.uint32) | 0x80000000)
        np.testing.assert_array_equal(np.argsort(order_bits(finite),
                                                 kind="stable"),
                                      np.argsort(finite, kind="stable"))

    def test_odd_radii_follow_torch_sort(self):
        # -0.0 and NaN radii inside beams: the kernel's order is the plain
        # version's (torch.sort), so the model equals star_search_plain.
        fk, r, z = _scattered(10, 60)
        rng = np.random.default_rng(10)
        odd = rng.random(fk.size) < 0.2
        r = np.where(odd, rng.choice(np.array([-0.0, np.nan, 0.0, -2.0],
                                              F32), fk.size), r).astype(F32)
        _check(fk, r, z, FilterConfig(), with_oracle=False)

    def test_scan_keys_match_jax_star(self):
        # On a scene's K1 keys the model equals the port's star_hits.
        from urban_road_filter_tpu.io.synthetic import SCENES, make_scan
        from urban_road_filter_torch.ops import geometry
        from urban_road_filter_torch.ops.ingest import ingest_prep

        cfg = FilterConfig()
        pts = make_scan(SCENES["two_curbs"](), n_rings=24, n_azimuth=384,
                        seed=5)
        x, y, z = (_t(np.ascontiguousarray(pts[:, k])) for k in range(3))
        _, fk, r_key, _ = ingest_prep(x[None], y[None], z[None], cfg)
        valid = geometry.roi_mask_xyz(x, y, z, cfg)
        hp = tstar.star_hits(x, y, z, valid, cfg).numpy()
        got = star_model(fk[0].numpy(), r_key[0].numpy(), z.numpy(), cfg)
        np.testing.assert_array_equal(got, hp)
        assert np.count_nonzero(hp) > 30


@settings(max_examples=25, deadline=None)
@given(n=st.integers(0, 400), beams=st.integers(1, 6),
       seed=st.integers(0, 2**31 - 1), dmin=st.integers(3, 8),
       kdev=st.sampled_from([0.5, 1.225, 5.0]),
       chunk=st.sampled_from([32, 40, CHUNK]))
def test_star_model_sweep(n, beams, seed, dmin, kdev, chunk):
    """Random short scans over a few beams with the sink, radii from a
    small set (ties, NaN slopes) and z with repeats and steps."""
    rng = np.random.default_rng(seed)
    fk = rng.choice(np.r_[rng.integers(0, BEAMS, beams), BEAMS],
                    n).astype(I32)
    r = rng.choice(rng.uniform(0, 10, 12).astype(F32), n).astype(F32)
    z = rng.choice(rng.normal(0, 0.1, 8).astype(F32), n).astype(F32)
    _check(fk, r, z, FilterConfig(kdev_param=kdev, dmin_param=dmin), chunk)


# ---------------------------------------------------------------- K5 model

def rank_model(ids, groups):
    """csrc/group_place.cu K5: per-tile histograms; per group the column
    scanned over the tiles in 32 slices of ceil(tiles / 32) tiles (slice
    sums, each slice rescanned from the sums of the slices before it); per
    tile the warps in order over running counts that start at the tile's
    column prefix."""
    n = ids.size
    tiles = -(-n // TILE)
    inr = (ids >= 0) & (ids < groups)
    hist = np.zeros((tiles, groups), np.int64)
    np.add.at(hist, (np.arange(n)[inr] // TILE, ids[inr]), 1)
    per = -(-tiles // 32)
    sums = np.stack([hist[w * per:(w + 1) * per].sum(0) for w in range(32)])
    base = np.cumsum(sums, 0) - sums  # per slice, per group
    counts = np.zeros(groups, np.int64)
    for w in range(32):
        run = base[w].copy()
        for t in range(w * per, min((w + 1) * per, tiles)):
            run, hist[t] = run + hist[t], run
        if w == 31:
            counts = run
    pos = np.full(n, -1, np.int64)
    for t in range(tiles):
        s = hist[t].copy()
        for w in range(TILE // 32):
            lo = t * TILE + w * 32
            seg = ids[lo:min(lo + 32, n)]
            for g in dict.fromkeys(seg[(seg >= 0) & (seg < groups)].tolist()):
                lanes_g = np.flatnonzero(seg == g)
                pos[lo + lanes_g] = s[g] + np.arange(lanes_g.size)
                s[g] += lanes_g.size
    return pos.astype(I32), counts.astype(I32)


def rank_direct(ids, groups):
    pos = np.full(ids.size, -1, I32)
    seen = np.zeros(groups, np.int64)
    for i, g in enumerate(ids.tolist()):
        if 0 <= g < groups:
            pos[i] = seen[g]
            seen[g] += 1
    return pos, seen.astype(I32)


class TestRankModel:
    @pytest.mark.parametrize("n,groups", [
        (1000, 1), (5 * 1024 + 17, 9), (20 * 1024 - 3, 65),
        (40 * 1024 + 1, 129), (30 * 1024 + 5, 1025), (25 * 1024 + 11, 2049),
        (300 * 1024 + 7, 9)])
    @pytest.mark.parametrize("outside", [False, True])
    def test_matches_xla_rank(self, n, groups, outside):
        rng = np.random.default_rng(n + groups)
        ids = rng.integers(0, groups, n).astype(I32)
        # Runs of one group, as rings of azimuth-major scans give them.
        ids[: n // 3] = np.repeat(ids[: n // 3: 37], 37)[: n // 3]
        if outside:
            bad = rng.random(n) < 0.1
            ids[bad] = rng.choice(np.array([-1, -9, groups, groups + 2],
                                           I32), int(bad.sum()))
        pos, counts = rank_model(ids, groups)
        want_pos, want_counts = rank_direct(ids, groups)
        np.testing.assert_array_equal(pos, want_pos)
        np.testing.assert_array_equal(counts, want_counts)
        inr = (ids >= 0) & (ids < groups)
        if not outside:
            tpos, tcounts = group_positions(_t(ids), groups)
            np.testing.assert_array_equal(tpos.numpy(), pos)
            np.testing.assert_array_equal(tcounts.numpy(), counts)
        # _xla_rank: exact for ids in range when none is negative.
        high = np.where(inr, ids, np.maximum(ids, groups)).astype(I32)
        jpos, jcounts = _xla_rank(jnp.asarray(high), groups)
        np.testing.assert_array_equal(np.asarray(jpos)[inr], pos[inr])
        np.testing.assert_array_equal(np.asarray(jcounts), counts)


@pytest.mark.parametrize("seed,kw", [
    (0, dict()), (1, dict(curb_slope_deg=20.0)),
    (2, dict(kdev_param=0.6, dmin_param=3)),
    (3, dict(kdist_param=9.0, dmin_param=30))])
def test_star_twin_takes_a_bound_config(seed, kw):
    """K4's twin gives the same hits with slope_param, kdev, kdist and
    dmin as 0-d tensors of a parameter buffer (config.device_config) as
    with the host values."""
    from urban_road_filter_torch.config import FilterConfig as TConfig
    from urban_road_filter_torch.config import device_config

    fk, r, z = (_t(a) for a in _scattered(seed))
    cfg = TConfig(**kw)
    bound = device_config(cfg, "cpu")
    assert bound.dmin_param.dtype == torch.int32
    assert torch.equal(tstar.star_search_plain(fk, r, z, bound),
                       tstar.star_search_plain(fk, r, z, cfg))
