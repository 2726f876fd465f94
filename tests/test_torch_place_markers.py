"""The rules of the placement (K6) and marker-table (K10) kernels, on the CPU.

The CUDA kernels (csrc/group_place.cu, csrc/markers.cu) run only on the
card, so their designs are held here as numpy models, step for step,
against the port's plain twins and the JAX package:

  * K6 writes an uninitialised (fields, R, P) output once: each landing
    point stores its fields, and the zero units store 0.0 to every slot
    s >= min(counts[r], P) of each row, through aligned 4-slot quads of
    the flat output; overflow is sum over r < rings of
    max(counts[r] - P, 0).  The model counts the writes of every slot
    (exactly one each) and must equal ``group_place_plain`` bit for bit,
    and, through ``tensorize``, the JAX ``geometry.tensorize``.
  * K10 splits the rings into row-blocks; each block reduces its rows in
    chunks to per-bin (max d, min key at that max) partials, and a merge
    keeps the larger d and, at equal d, the smaller key.  For 1, 2, 7 and
    R blocks and chunks down to one quad, the model must equal
    ``marker_points_plain`` bit for bit, and the JAX ``marker_points`` on
    the azimuth-sorted layout.
  * K13 does the same for a minimum alone: each block owns a ring row
    (the model takes any number of rows a block), folds the runs of one
    bin within a quad of its non-road keys into per-bin minima in shared
    memory, then folds those into kf with atomicMin (a minimum, in any
    order).  The model must equal ``first_nonroad_keys`` at 1, 2, 7 and R
    rows per block and passes down to one quad, and its kf through the
    K10 twin must give the table of the interpreted
    ``marker_points_unsorted_pallas(kf=None)``.

Exact equality is the demand throughout: the same numpy inputs go to
every side, and none of the steps rounds.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
import torch

from urban_road_filter_tpu.config import FilterConfig
from urban_road_filter_tpu.io.synthetic import SCENES, make_scan
from urban_road_filter_tpu.ops import blind_spots as jbs
from urban_road_filter_tpu.ops import geometry as jgeo
from urban_road_filter_tpu.ops import markers as jmk
from urban_road_filter_tpu.ops.marker_scan import (
    marker_points_unsorted_pallas)
from urban_road_filter_tpu.ops.xzero import x_zero as jx_zero
from urban_road_filter_tpu.ops.zzero import z_zero as jz_zero
from urban_road_filter_torch.convert import layout_from_numpy, to_numpy
from urban_road_filter_torch.ops import geometry as tgeo
from urban_road_filter_torch.ops import markers as tmk
from urban_road_filter_torch.ops.place import group_place, group_place_plain
from urban_road_filter_torch.ops.rank import group_positions

torch.set_num_threads(1)  # tier-1 runs several pytest workers

F32 = np.float32
I32 = np.int32
NO_KEY = np.iinfo(np.int64).max
N_BINS = 361
ZERO_QUADS = 256  # quads per zero unit (csrc/group_place.cu kZeroQuads)
MARK_CHUNK = 1024  # quads per K10 chunk (kMarkThreads * kMarkQuads)
FIRST_PASS = 512  # quads of a row per K13 pass (kFirstPass: 256 x 2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(a):
    return np.asarray(a, F32).view(I32)


# ---------------------------------------------------------------- K6 model


def place_model(ids, pos, counts, fields, rings, cap):
    """csrc/group_place.cu's place_kernel on the host: (out, overflow,
    writes), out starting as NaN (uninitialised) and writes counting the
    stores that reached each slot."""
    nf = len(fields)
    out = np.full(nf * rings * cap, np.nan, F32)
    writes = np.zeros(nf * rings * cap, np.int64)
    plane = rings * cap
    lands = (ids >= 0) & (ids < rings) & (pos >= 0) & (pos < cap)
    o = ids[lands].astype(np.int64) * cap + pos[lands]
    for f, v in enumerate(fields):
        out[f * plane + o] = v[lands]
        np.add.at(writes, f * plane + o, 1)
    units_per_row = (cap // 4 + 2 + ZERO_QUADS - 1) // ZERO_QUADS
    for row in range(nf * rings):
        lim = min(max(int(counts[row % rings]), 0), cap)
        lo, hi = row * cap + lim, row * cap + cap
        for seg in range(units_per_row):
            q_first = lo // 4 + seg * ZERO_QUADS
            q_end = min((hi + 3) // 4, q_first + ZERO_QUADS)
            for q in range(q_first, q_end):
                e = np.arange(4 * q, 4 * q + 4)
                e = e[(e >= lo) & (e < hi)]
                out[e] = 0.0
                writes[e] += 1
    overflow = np.int32(np.maximum(counts[:rings].astype(np.int64) - cap,
                                   0).sum())
    return (out.reshape(nf, rings, cap), overflow,
            writes.reshape(nf, rings, cap))


def _place_vs_twin(ids, fields, rings, cap):
    """The K6 model against group_place (the twin on the CPU), every slot
    written once; returns the twin's overflow."""
    pos, counts = group_positions(_t(ids), rings + 1)
    out, overflow, writes = place_model(ids, pos.numpy(), counts.numpy(),
                                        fields, rings, cap)
    assert (writes == 1).all(), "every slot must be written exactly once"
    got = group_place(_t(ids), pos, counts, tuple(map(_t, fields)), rings,
                      cap)
    assert len(got) == len(fields) + 1
    for g, w in zip(got[:-1], out):
        assert g.dtype == torch.float32 and g.shape == (rings, cap)
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
    assert int(got[-1]) == int(overflow)
    return int(overflow)


class TestPlaceRule:
    @pytest.mark.parametrize("cap", [64, 61, 1023, 3, 1])
    @pytest.mark.parametrize("nf", [1, 2, 3])
    def test_scatter_tail_zero_and_overflow(self, cap, nf):
        # Rings past capacity, rings left empty, the dump group (ids ==
        # rings) and NaN values on every dropped point; P % 4 != 0 for 61,
        # 1023, 3 and 1.
        rng = np.random.default_rng(cap * 10 + nf)
        n, rings = 3000, 12
        ids = rng.choice(np.array([0, 1, 2, 4, 5, 7, 9, 10, rings], I32), n,
                         p=[.3, .2, .1, .1, .1, .05, .05, .03, .07])
        pos = group_positions(_t(ids), rings + 1)[0].numpy()
        dropped = (ids == rings) | (pos >= cap)
        fields = [rng.standard_normal(n).astype(F32) for _ in range(nf)]
        for v in fields:
            v[dropped] = np.nan
        overflow = _place_vs_twin(ids, fields, rings, cap)
        assert overflow == int(np.sum((ids < rings) & (pos >= cap)))
        assert (overflow > 0) == (cap < 900)

    def test_no_points_and_one_point(self):
        _place_vs_twin(np.zeros(0, I32), [np.zeros(0, F32)] * 3, 4, 10)
        _place_vs_twin(np.array([2], I32), [np.array([7.0], F32)], 4, 10)

    @settings(max_examples=40, deadline=None)
    @given(seed=st.integers(0, 2 ** 31 - 1), n=st.integers(0, 600),
           rings=st.integers(1, 9), cap=st.integers(1, 70),
           nf=st.integers(1, 3))
    def test_property(self, seed, n, rings, cap, nf):
        rng = np.random.default_rng(seed)
        ids = rng.integers(0, rings + 1, n).astype(I32)
        fields = [rng.standard_normal(n).astype(F32) for _ in range(nf)]
        _place_vs_twin(ids, fields, rings, cap)

    @pytest.mark.parametrize("scene,cap", [("two_curbs", 61),
                                           ("blind_spot", 1023),
                                           ("curb_gap", 30)])
    def test_tensorize_matches_jax(self, scene, cap):
        # Ragged and small capacities through tensorize, whose rows-layout
        # x/y/z are strided views (stride 4), against the JAX package.
        cfg = FilterConfig()
        pts = make_scan(SCENES[scene](), n_rings=24, n_azimuth=384, seed=2)
        x, y, z = (np.ascontiguousarray(pts[:, k]) for k in range(3))
        jx, jy, jz = map(jnp.asarray, (x, y, z))
        valid = jgeo.roi_mask_xyz(jx, jy, jz, cfg)
        _, av = jgeo.vertical_angles(jx, jy, jz)
        angles, _ = jgeo.discover_rings(av, valid, cfg.interval)
        ring_id = np.asarray(jgeo.assign_rings(av, valid, angles,
                                               cfg.interval))
        jl, jpos = jgeo.tensorize(jx, jy, jz, jnp.asarray(ring_id), cap,
                                  rings=64)
        rows = _t(pts[:, :4].astype(F32))
        tx, ty, tz, _ = tgeo.xyz_of(rows, "rows")
        assert tx.stride(0) == 4
        tl, tpos, _ = tgeo.tensorize(tx, ty, tz, _t(ring_id), cap, rings=64)
        tl = to_numpy(tl)
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        for f in ("x", "y", "z", "d2", "label", "pid", "counts", "overflow"):
            got, want = getattr(tl, f), np.asarray(getattr(jl, f))
            assert got.dtype == want.dtype, f
            np.testing.assert_array_equal(got, want, err_msg=f)
        # The model on the same ids and strided fields.
        _place_vs_twin(ring_id.astype(I32), [x, y, z], 64, cap)


# --------------------------------------------------------------- K10 model


def marker_keys_np(alpha):
    r, p = alpha.shape
    bits = (alpha + F32(0.0)).view(np.uint32).astype(np.int64)
    return ((np.arange(r, dtype=np.int64)[:, None] << 48) | (bits << 16)
            | np.arange(p, dtype=np.int64)[None, :])


def _better(d, k, bd, bk):
    return d > bd or (d == bd and k < bk)


def markers_model(lay, num_rings, kf, blocks, chunk=MARK_CHUNK, seed=0):
    """csrc/markers.cu's marker_points_kernel on the host: ``blocks``
    row-blocks, each reducing its rows in chunks of ``chunk`` aligned
    quads of the flat arrays to per-bin partials, then the merge (in a
    shuffled order: the result must not depend on it)."""
    alpha, d2, label = lay.alpha, lay.d2, lay.label
    r_all, p = alpha.shape
    nr = min(int(num_rings), r_all)
    keys = marker_keys_np(alpha)
    dbits = d2.view(np.uint32).astype(np.int64)
    part_d = np.zeros((N_BINS, blocks), np.int64)
    part_k = np.full((N_BINS, blocks), NO_KEY, np.int64)
    for g in range(blocks):
        s_d = np.zeros(N_BINS, np.int64)
        s_prev = np.zeros(N_BINS, np.int64)
        s_key = np.full(N_BINS, NO_KEY, np.int64)
        for r in range(g, nr, blocks):
            cnt = min(max(int(lay.counts[r]), 0), p)
            if cnt == 0:
                continue
            q_lo = (r * p) // 4
            nq = (r * p + cnt - 1) // 4 - q_lo + 1
            for c in range(0, nq, chunk):
                e_lo, e_hi = 4 * (q_lo + c), 4 * (q_lo + min(c + chunk, nq))
                s = np.arange(max(e_lo, r * p), min(e_hi, r * p + cnt)) - r * p
                a, d, lab = alpha[r, s], d2[r, s], label[r, s]
                with np.errstate(invalid="ignore"):
                    ok = (a >= 0) & (a <= 360) & (lab == 1) & (d > 0)
                bins = np.where(ok, np.floor(np.where(ok, a, 0)), 0).astype(
                    np.int64)
                ok &= keys[r, s] < kf[bins]
                np.maximum.at(s_d, bins[ok], dbits[r, s][ok])
                rose = s_d != s_prev
                s_key[rose] = NO_KEY
                s_prev = s_d.copy()
                win = ok & (dbits[r, s] == s_d[bins])
                np.minimum.at(s_key, bins[win], keys[r, s][win])
        part_d[:, g], part_k[:, g] = s_d, s_key
    order = np.random.default_rng(seed).permutation(blocks)
    table = np.zeros((N_BINS, 6), F32)
    for b in range(N_BINS):
        bd, bk = 0, NO_KEY
        for g in order:
            if _better(part_d[b, g], part_k[b, g], bd, bk):
                bd, bk = part_d[b, g], part_k[b, g]
        if bd:
            ring, slot = bk >> 48, bk & 0xFFFF
            table[b, 1:4] = lay.x[ring, slot], lay.y[ring, slot], \
                lay.z[ring, slot]
        table[b, 0] = 1.0 if bd else 0.0
        table[b, 4] = 1.0 if kf[b] != NO_KEY else 0.0
        table[b, 5] = b
    return table


def _model_vs_twin(lay, num_rings, kf=None, chunks=(MARK_CHUNK, 1, 3)):
    """The K10 model at 1, 2, 7 and R row-blocks against the twin; returns
    the twin's table."""
    tl = layout_from_numpy(lay)
    nr = _t(np.int32(num_rings))
    if kf is None:
        kf = tmk.first_nonroad_keys(tl, nr).numpy()
    want = tmk.marker_points(tl, nr, _t(kf)).numpy()
    r = lay.alpha.shape[0]
    for blocks in sorted({1, 2, 7, r}):
        for chunk in chunks:
            got = markers_model(to_numpy(tl), num_rings, kf, blocks, chunk,
                                seed=blocks + chunk)
            np.testing.assert_array_equal(_bits(got), _bits(want),
                                          err_msg=f"{blocks} blocks")
    return want


def _jax_flooded(scene, seed, cfg):
    pts = make_scan(SCENES[scene](), n_rings=24, n_azimuth=384, seed=seed)
    x, y, z = (jnp.asarray(np.ascontiguousarray(pts[:, k]))
               for k in range(3))
    valid = jgeo.roi_mask_xyz(x, y, z, cfg)
    _, av = jgeo.vertical_angles(x, y, z)
    angles, _ = jgeo.discover_rings(av, valid, cfg.interval)
    ring_id = jgeo.assign_rings(av, valid, angles, cfg.interval)
    layout, _ = jgeo.tensorize(x, y, z, ring_id, 512)
    layout = jz_zero(jx_zero(layout, cfg), cfg)
    num_rings = jnp.sum(layout.counts > 0).astype(jnp.int32)
    return jbs.blind_spots(layout, jgeo.max_distance(layout), num_rings,
                           cfg), num_rings


def _jax_table(layout, num_rings):
    return np.asarray(jmk.marker_points(jgeo.sort_by_azimuth(layout),
                                        jnp.int32(num_rings)))


def _tie_layout(rings=8, seed=0):
    """A JAX layout, all road, whose farthest point of each of a few bins
    is copied into several rings, twice into one: the same max d in
    several rings and row-blocks of a bin (the smallest key must win)."""
    rng = np.random.default_rng(seed)
    n = 600
    theta = rng.uniform(0, 2 * np.pi, n)
    rho = rng.uniform(2.0, 30.0, n)
    x = (rho * np.cos(theta)).astype(F32)
    y = (rho * np.sin(theta)).astype(F32)
    z = rng.uniform(-1.8, -1.4, n).astype(F32)
    ring = rng.integers(0, rings, n).astype(I32)
    _, alpha = jgeo.azimuth_2d(jnp.asarray(x), jnp.asarray(y))
    bins = np.floor(np.asarray(alpha)).astype(int)
    extra = []
    for b in np.unique(bins)[::5]:
        far = np.flatnonzero(bins == b)[np.argmax(rho[bins == b])]
        for r in list(rng.choice(rings, 4, replace=False)) + [ring[far]]:
            extra.append((x[far], y[far], z[far], r))
    ex = np.array(extra, dtype=object)
    x = np.concatenate([x, ex[:, 0].astype(F32)])
    y = np.concatenate([y, ex[:, 1].astype(F32)])
    z = np.concatenate([z, ex[:, 2].astype(F32)])
    ring = np.concatenate([ring, ex[:, 3].astype(I32)])
    perm = rng.permutation(len(x))
    layout, _ = jgeo.tensorize(*(jnp.asarray(a[perm]) for a in
                                 (x, y, z, ring)), 256, rings=rings)
    return layout._replace(label=jnp.ones_like(layout.label))


class TestMarkerRule:
    @pytest.mark.parametrize("scene", ["two_curbs", "blind_spot", "flat"])
    def test_scenes_match_twin_and_jax(self, scene):
        layout, num_rings = _jax_flooded(scene, 7, FilterConfig())
        got = _model_vs_twin(jgeo.RingLayout(*map(np.asarray, layout)),
                             int(num_rings))
        want = _jax_table(layout, int(num_rings))
        assert want[:, 0].sum() > 0
        np.testing.assert_array_equal(got, want)

    def test_cross_block_ties_smallest_key_wins(self):
        layout = _tie_layout()
        lay = jgeo.RingLayout(*map(np.asarray, layout))
        got = _model_vs_twin(lay, 8)
        np.testing.assert_array_equal(got, _jax_table(layout, 8))
        # Each copied bin: the winner is the smallest (ring, slot) among
        # the points at the max distance.
        keys = marker_keys_np(lay.alpha)
        valid = np.arange(256)[None, :] < lay.counts[:, None]
        ties = 0
        for b in np.flatnonzero(got[:, 0]):
            in_bin = valid & (np.floor(lay.alpha) == b) & (lay.d2 > 0)
            dmax = lay.d2[in_bin].max()
            at = in_bin & (lay.d2 == dmax)
            ties += int(at.sum() > 1)
            k = keys[at].min()
            assert got[b, 1] == lay.x[k >> 48, k & 0xFFFF]
        assert ties >= 5, "the layout must hold ties across rings"

    def test_every_candidate_past_kf(self):
        # A bin whose first point in scan order is not road: every road
        # point of the bin lies past kf, so no marker but a red flag.
        layout = _tie_layout(seed=1)
        lay = jgeo.RingLayout(*map(np.array, layout))
        keys = marker_keys_np(lay.alpha)
        valid = np.arange(256)[None, :] < lay.counts[:, None]
        bins = np.where(valid, np.floor(lay.alpha), -1)
        hidden = [b for b in range(N_BINS) if (bins == b).sum() >= 3][::7]
        assert len(hidden) >= 3
        for b in hidden:
            k = keys[bins == b].min()
            lay.label[k >> 48, k & 0xFFFF] = 0
        got = _model_vs_twin(lay, 8)
        np.testing.assert_array_equal(got, _jax_table(
            jgeo.RingLayout(*map(jnp.asarray, lay)), 8))
        for b in hidden:
            assert got[b, 0] == 0 and got[b, 4] == 1

    @pytest.mark.parametrize("num_rings", [0, 3, 5])
    def test_num_rings_below_rows(self, num_rings):
        layout = _tie_layout(seed=2)
        lay = jgeo.RingLayout(*map(np.asarray, layout))
        got = _model_vs_twin(lay, num_rings)
        np.testing.assert_array_equal(got, _jax_table(layout, num_rings))
        assert (got[:, 0].sum() > 0) == (num_rings > 0)

    def test_empty_counts(self):
        layout = _tie_layout(seed=3)
        lay = jgeo.RingLayout(*map(np.asarray, layout))._replace(
            counts=np.zeros(8, I32))
        got = _model_vs_twin(lay, 8)
        assert not got[:, :5].any()
        np.testing.assert_array_equal(got[:, 5], np.arange(N_BINS))

    @settings(max_examples=30, deadline=None)
    @given(seed=st.integers(0, 2 ** 31 - 1), rings=st.integers(1, 9),
           p=st.integers(1, 40), nr=st.integers(0, 10))
    def test_property(self, seed, rings, p, nr):
        # Random labels, counts and kf; alpha with NaN, negative, 360,
        # -0.0 and repeats; d2 with zeros and repeats; ragged p.
        rng = np.random.default_rng(seed)
        alpha = rng.choice(np.array([np.nan, -3.0, 360.0, -0.0, 0.0, 5.5,
                                     5.25, 359.9, 200.0], F32),
                           (rings, p))
        alpha = np.where(rng.random((rings, p)) < 0.5, alpha,
                         rng.uniform(0, 361, (rings, p))).astype(F32)
        d2 = rng.choice(np.array([0.0, 1.5, 7.0, 7.0, 3.25], F32),
                        (rings, p))
        d2 = np.where(rng.random((rings, p)) < 0.6, d2,
                      rng.uniform(0, 9, (rings, p))).astype(F32)
        label = rng.choice(np.array([0, 1, 1, 1, 2], I32), (rings, p))
        counts = rng.integers(0, p + 3, rings).astype(I32)
        xyz = [rng.standard_normal((rings, p)).astype(F32) for _ in range(3)]
        lay = jgeo.RingLayout(*xyz, d2, alpha, label,
                              np.full((rings, p), -1, I32), counts,
                              np.int32(0))
        keys = marker_keys_np(alpha).ravel()
        kf = np.where(rng.random(N_BINS) < 0.5, NO_KEY,
                      rng.choice(keys, N_BINS)).astype(np.int64)
        _model_vs_twin(lay, nr, kf, chunks=(MARK_CHUNK, 1))


# --------------------------------------------------------------- K13 model


def first_nonroad_model(lay, num_rings, rows_per_block, chunk=FIRST_PASS,
                        seed=0):
    """csrc/markers.cu's first_nonroad_kernel on the host: blocks of
    ``rows_per_block`` whole rows; each reads its rows' counted slots in
    passes of ``chunk`` aligned quads of the flat arrays and folds each run
    of one bin within a quad into one minimum (one shared atomic); then
    the blocks fold their 361 minima into kf in a shuffled order (global
    atomicMin).  Returns (kf, shared atomics made)."""
    alpha, label = lay.alpha, lay.label
    r_all, p = alpha.shape
    nr = min(int(num_rings), r_all)
    keys = marker_keys_np(alpha)
    blocks = max(1, -(-r_all // rows_per_block))
    part = np.empty((N_BINS, blocks), np.int64)
    atomics = 0
    for g in range(blocks):
        s_key = np.full(N_BINS, NO_KEY, np.int64)
        for r in range(g * rows_per_block,
                       min((g + 1) * rows_per_block, max(nr, 0))):
            cnt = min(max(int(lay.counts[r]), 0), p)
            if cnt == 0:
                continue
            q_lo = (r * p) // 4
            nq = (r * p + cnt - 1) // 4 - q_lo + 1
            for c in range(0, nq, chunk):
                e_lo, e_hi = 4 * (q_lo + c), 4 * (q_lo + min(c + chunk, nq))
                s = np.arange(max(e_lo, r * p), min(e_hi, r * p + cnt)) - r * p
                a = alpha[r, s]
                with np.errstate(invalid="ignore"):
                    ok = (a >= 0) & (a <= 360) & (label[r, s] != 1)
                s, a = s[ok], a[ok]
                if s.size == 0:
                    continue
                bins = np.floor(a).astype(np.int64)
                quad = (r * p + s) // 4
                new_run = np.ones(s.size, bool)
                new_run[1:] = (quad[1:] != quad[:-1]) | (bins[1:] != bins[:-1])
                starts = np.flatnonzero(new_run)
                run_min = np.minimum.reduceat(keys[r, s], starts)
                np.minimum.at(s_key, bins[starts], run_min)
                atomics += starts.size
        part[:, g] = s_key
    order = np.random.default_rng(seed).permutation(blocks)
    kf = np.full(N_BINS, NO_KEY, np.int64)
    for g in order:
        kf = np.minimum(kf, part[:, g])
    return kf, atomics


def _first_vs_twin(lay, num_rings, chunks=(FIRST_PASS, 1, 3)):
    """The K13 model at 1, 2, 7 and R rows per block against the twin;
    returns the twin's kf."""
    tl = layout_from_numpy(lay)
    want = tmk.first_nonroad_keys(tl, _t(np.int32(num_rings))).numpy()
    r = lay.alpha.shape[0]
    for blocks in sorted({1, 2, 7, r}):
        for chunk in chunks:
            got, _ = first_nonroad_model(lay, num_rings, blocks, chunk,
                                         seed=blocks + chunk)
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{blocks} blocks")
    return want


def _pallas_table(layout, num_rings):
    """The interpreted marker_points_unsorted_pallas(kf=None): K13's and
    K10's TPU kernels in one call."""
    return np.asarray(marker_points_unsorted_pallas(
        layout, jnp.int32(num_rings), interpret=True))


def _first_vs_pallas(layout, num_rings):
    """The model's kf through the K10 twin equals the interpreted Pallas
    table; returns the model's kf."""
    lay = jgeo.RingLayout(*map(np.asarray, layout))
    kf = _first_vs_twin(lay, num_rings)
    got = tmk.marker_points(layout_from_numpy(lay),
                            _t(np.int32(num_rings)), _t(kf)).numpy()
    np.testing.assert_array_equal(_bits(got),
                                  _bits(_pallas_table(layout, num_rings)))
    return kf


class TestFirstNonroadRule:
    @pytest.mark.parametrize("scene", ["two_curbs", "curb_gap"])
    def test_scenes_match_twin_and_pallas(self, scene):
        layout, num_rings = _jax_flooded(scene, 7, FilterConfig())
        kf = _first_vs_pallas(layout, int(num_rings))
        assert (kf != NO_KEY).sum() > 50

    def test_runs_fold_into_one_atomic_per_bin_and_quad(self):
        # An azimuth-ordered row at 8 slots a degree (an OS1 ring at 2880
        # firings): neighbours share a bin, so a quad makes one atomic.
        rings, p = 4, 2880
        alpha = np.tile(np.linspace(0, 359.99, p, dtype=F32), (rings, 1))
        zero = np.zeros((rings, p), F32)
        lay = jgeo.RingLayout(zero, zero, zero, zero, alpha,
                              np.zeros((rings, p), I32),
                              np.full((rings, p), -1, I32),
                              np.full(rings, p - 5, I32), np.int32(0))
        kf, atomics = first_nonroad_model(lay, rings, 1)
        assert atomics <= rings * (p // 4 + 361), atomics
        np.testing.assert_array_equal(kf, _first_vs_twin(lay, rings))
        assert (kf != NO_KEY).sum() == 360

    def test_ties_keep_the_smallest_key(self):
        # Equal azimuths in several rings and slots of a bin: the smallest
        # ring, then the smallest slot, wins.
        layout = _tie_layout(seed=4)
        lay = jgeo.RingLayout(*map(np.array, layout))
        lay.label[:] = 2
        lay.alpha[:, :] = np.where(np.arange(256) % 3 == 0, F32(10.5),
                                   lay.alpha)
        layout = jgeo.RingLayout(*map(jnp.asarray, lay))
        kf = _first_vs_pallas(layout, 8)
        valid = np.arange(256)[None, :] < lay.counts[:, None]
        at = valid & (lay.alpha == F32(10.5))
        ring = np.flatnonzero(at.any(1))[0]
        slot = np.flatnonzero(at[ring])[0]
        assert kf[10] == marker_keys_np(lay.alpha)[ring, slot]

    def test_all_road_and_empty_layouts(self):
        layout = _tie_layout(seed=5)  # every slot road
        kf = _first_vs_pallas(layout, 8)
        assert (kf == NO_KEY).all()
        empty = layout._replace(counts=jnp.zeros(8, jnp.int32),
                                label=jnp.zeros_like(layout.label))
        assert (_first_vs_pallas(empty, 8) == NO_KEY).all()

    @pytest.mark.parametrize("num_rings", [0, 1, 5])
    def test_num_rings_below_rows(self, num_rings):
        layout, _ = _jax_flooded("blind_spot", 3, FilterConfig())
        kf = _first_vs_pallas(layout, num_rings)
        assert ((kf != NO_KEY).any()) == (num_rings > 0)

    def test_nan_and_out_of_range_azimuths(self):
        layout, num_rings = _jax_flooded("two_curbs", 9, FilterConfig())
        lay = jgeo.RingLayout(*map(np.array, layout))
        rng = np.random.default_rng(11)
        pick = rng.random(lay.alpha.shape) < 0.2
        lay.alpha[pick] = rng.choice(
            np.array([np.nan, -0.0, -1e-7, 360.0, 360.00003, -5.0], F32),
            int(pick.sum()))
        lay.label[rng.random(lay.label.shape) < 0.3] = 0
        kf = _first_vs_pallas(jgeo.RingLayout(*map(jnp.asarray, lay)),
                              int(num_rings))
        assert kf[360] != NO_KEY and kf[0] != NO_KEY

    @settings(max_examples=30, deadline=None)
    @given(seed=st.integers(0, 2 ** 31 - 1), rings=st.integers(1, 9),
           p=st.integers(1, 40), nr=st.integers(0, 10))
    def test_property(self, seed, rings, p, nr):
        rng = np.random.default_rng(seed)
        alpha = rng.choice(np.array([np.nan, -3.0, 360.0, -0.0, 0.0, 5.5,
                                     5.25, 359.9, 200.0], F32),
                           (rings, p))
        alpha = np.where(rng.random((rings, p)) < 0.5, alpha,
                         rng.uniform(0, 361, (rings, p))).astype(F32)
        label = rng.choice(np.array([0, 1, 1, 2], I32), (rings, p))
        counts = rng.integers(-1, p + 3, rings).astype(I32)
        zero = np.zeros((rings, p), F32)
        lay = jgeo.RingLayout(zero, zero, zero, zero, alpha, label,
                              np.full((rings, p), -1, I32), counts,
                              np.int32(0))
        _first_vs_twin(lay, nr, chunks=(FIRST_PASS, 1))
