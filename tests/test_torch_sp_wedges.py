"""The wedge axis of K8 (flood_blocked) and K14 (marker_state), on the CPU.

The azimuth-sharded path hands both kernels its stacked layout, D wedges of
R rings ((D * R, P), ring k of wedge w at row w * R + k), and each returns
the D per-wedge results stacked, from one launch.  Here:

- the wedge-axis twins against the JAX package's ``blocked_pallas`` and
  ``marker_state_pallas`` run per wedge in interpret mode and stacked, on
  stacked layouts of the SP tests' scenes: pass 1 and pass 2 of the
  markers (the SP offsets ring x P_glob + prefix, a (D, 361) f_init),
  an empty wedge, rows at or past num_rings and NaN azimuths.  Bit-equal,
  but for K14's maxd against interpreted Pallas, which contracts its
  sqrt(x*x + y*y) into a fused multiply-add: one ulp there, and the
  state's markers bit-equal to the eager XLA ops; the wedge axis bit-equal
  to the per-wedge calls stacked.
- a numpy model of K8's rule (csrc/flood.cu, blocked_kernel): per row the
  smallest curb azimuth per top start (floor) and the largest per first
  start (ceil), a suffix minimum and a prefix maximum over the 362 starts
  (the nearest curb at or after, and at or before, each start) compared
  with the window's far end rounded once in np.float32, the special starts
  set from their own bound.  It must equal the dense ``blocked_bits`` twin
  bit for bit, on window ends, NaN and +-inf widths, azimuths in
  [-10, 370] and a hypothesis sweep.
- a numpy model of K14's three phases (csrc/markers.cu, marker_state_kernel):
  per row group the smallest non-road g per bin against f_init, written
  whole, the wedge's f merged from those partials, per group K10's chunk
  scheme in steps (max of d, forget the key of
  a bin whose max rose, min key g << 32 | flat at the max), then the merge
  (larger d wins, equal d keeps the smaller key).  It must equal
  ``marker_state_plain`` bit for bit, the tie rule included.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from urban_road_filter_tpu.config import FilterConfig as JaxConfig
from urban_road_filter_tpu.constants import LABEL_CURB
from urban_road_filter_tpu.io.synthetic import SCENES, make_scan
from urban_road_filter_tpu.ops import blind_spots as jbs
from urban_road_filter_tpu.ops import geometry as jgeo
from urban_road_filter_tpu.ops.flood_scan import blocked_pallas
from urban_road_filter_tpu.ops.marker_scan import marker_state_pallas
from urban_road_filter_tpu.ops.markers import marker_points as jmarkers
from urban_road_filter_tpu.ops.star import star_shaped
from urban_road_filter_torch.convert import layout_from_numpy
from urban_road_filter_torch.ops import blind_spots as bs
from urban_road_filter_torch.ops.geometry import RingLayout, azimuth_2d
from urban_road_filter_torch.ops.marker_state import (
    F_NONE, marker_state, marker_state_plain)

torch.set_num_threads(1)  # tier-1 runs several pytest workers

F32 = np.float32
I32 = np.int32
STARTS = 362
BINS = 361
RINGS, CAP = 16, 256
SCENES_OF = (("two_curbs", 0), ("blind_spot", 4), ("curb_gap", 7))
WIDTHS = (0.0, 1e-30, 1.0, 37.5, 361.0, 1e30, np.inf, -np.inf, np.nan)


@functools.lru_cache(maxsize=None)
def _wedge(scene: str, seed: int, bz: float, flooded: bool):
    """One wedge's JAX layout (star marks as curbs, eager JAX ops), sorted
    by azimuth, flooded when asked; and its ring count."""
    cfg = JaxConfig(beam_zone=bz)
    pts = make_scan(SCENES[scene](), n_rings=RINGS, n_azimuth=CAP, seed=seed)
    pts = jnp.asarray(pts[:RINGS * CAP, :4].astype(F32))
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    valid = jgeo.roi_mask(pts, cfg)
    labels0, _ = star_shaped(pts, valid, jnp.zeros(len(pts), jnp.int32),
                             cfg, 0)
    _, av = jgeo.vertical_angles(x, y, z)
    angles, nr = jgeo.discover_rings(av, valid, cfg.interval)
    ring_id = jgeo.assign_rings(av, valid, angles, cfg.interval)
    layout, _ = jgeo.tensorize(x, y, z, ring_id, CAP, label=labels0,
                               with_pid=True, rings=RINGS)
    if flooded:
        layout = jbs.blind_spots(layout, jgeo.max_distance(layout), nr, cfg)
    return jgeo.sort_by_azimuth(layout), int(nr)


def _edit(layout, case: str, k: int):
    """Wedge k's edge case: no slot at all ("empty", wedge 2), or
    NaN-azimuth curb and road points on rings 1 and 3 ("nan", wedge 1)."""
    if case == "empty" and k == 2:
        return layout._replace(counts=jnp.zeros_like(layout.counts))
    if case == "nan" and k == 1:
        x = np.asarray(layout.x).copy()
        y = np.asarray(layout.y).copy()
        lab = np.asarray(layout.label).copy()
        for ring, label in ((1, LABEL_CURB), (3, 1)):
            x[ring, :3] = 0.0
            y[ring, :3] = 0.0
            lab[ring, :3] = label
        d2, alpha = jgeo.azimuth_2d(jnp.asarray(x), jnp.asarray(y))
        assert np.isnan(np.asarray(alpha)[1, :3]).all()
        return layout._replace(x=jnp.asarray(x), y=jnp.asarray(y), d2=d2,
                               alpha=alpha, label=jnp.asarray(lab))
    return layout


def _stacked(case: str, bz: float, flooded: bool):
    """(per-wedge JAX layouts, the port's stacked layout, num_rings)."""
    wedges, nrs = [], []
    for k, (scene, seed) in enumerate(SCENES_OF):
        lay, nr = _wedge(scene, seed, bz, flooded)
        wedges.append(_edit(lay, case, k))
        nrs.append(nr)
    nr = 5 if case == "rings5" else max(nrs)
    ports = [layout_from_numpy(w) for w in wedges]
    stacked = RingLayout(*(torch.cat([getattr(p, f) for p in ports])
                           if f != "overflow" else ports[0].overflow
                           for f in RingLayout._fields))
    return wedges, stacked, nr


CASES = ["plain", "empty", "nan", "rings5"]


def _sp_offsets(d, seed):
    """The SP path's offsets ring * P_glob + wedge prefix (D, R) and a
    pass-2 floor per wedge (D, 361): integer positions, some bins 3e38."""
    rng = np.random.default_rng(seed)
    p_glob = d * CAP + 1
    counts = rng.integers(0, CAP, d)
    prefix = np.cumsum(counts) - counts
    goff = np.arange(RINGS)[None, :] * p_glob + prefix[:, None]
    f_init = np.where(rng.random(BINS) < 0.3, F32(3e38),
                      rng.integers(0, RINGS * p_glob, BINS).astype(F32))
    return goff.astype(I32), np.tile(f_init.astype(F32), (d, 1))


@pytest.mark.parametrize("case,bz", [("plain", 30.0), ("plain", 45.5),
                                     ("empty", 30.0), ("nan", 30.0)])
def test_blocked_wedges_equal_pallas(case, bz):
    """K8's wedge-axis twin against blocked_pallas in interpret mode per
    wedge, stacked (compares only: exact)."""
    wedges, stacked, _ = _stacked(case, bz, flooded=False)
    md = np.max([np.asarray(jgeo.max_distance(w)) for w in wedges], 0)
    w = jbs.window_widths(jnp.asarray(md), bz)
    want = [np.stack([np.asarray(b[i]) for b in (
        blocked_pallas(lay, w, bz, interpret=True) for lay in wedges)])
        for i in (0, 1)]
    got = bs.flood_blocked(stacked, torch.from_numpy(np.array(w)), bz,
                           wedges=len(wedges))
    for g, wt in zip(got, want):
        assert g.shape == (len(wedges), RINGS, STARTS)
        np.testing.assert_array_equal(g.numpy(), wt)
    if case == "plain":
        assert want[0].any() and want[1].any()
    if case == "empty":
        assert not want[0][2].any() and not want[1][2].any()


@pytest.mark.parametrize("case", CASES[:3])
def test_blocked_wedges_equal_2d_calls(case):
    """The wedge axis equals the per-wedge 2-D calls stacked."""
    wedges, stacked, _ = _stacked(case, 30.0, flooded=False)
    w = torch.from_numpy(np.linspace(30, 2, RINGS).astype(F32))
    got = bs.flood_blocked(stacked, w, 30.0, wedges=len(wedges))
    for i in (0, 1):
        want = torch.stack([bs.flood_blocked(
            layout_from_numpy(lay), w, 30.0)[i] for lay in wedges])
        assert torch.equal(got[i], want)


def _assert_state(got, want):
    """K14 state against the interpreted kernel, as
    tests/test_torch_sp_kernels.py holds the 2-D call: interpreted Pallas on
    the CPU contracts the kernel's d = sqrt(x*x + y*y) into a fused
    multiply-add, so maxd is held within one ulp and, where the two agree
    exactly, the rest of the row bit for bit; f bit for bit everywhere.
    (The markers of the same state are held bit-equal to the eager XLA
    ops below.)"""
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_array_max_ulp(got[..., 1], want[..., 1], maxulp=1)
    same = got[..., 1] == want[..., 1]
    assert same.mean() > 0.9
    np.testing.assert_array_equal(got[same], want[same])


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_marker_state_wedges_equal_pallas(case, sp):
    """K14's wedge-axis twin against marker_state_pallas in interpret mode
    per wedge, stacked: pass 1 (default offsets, or the SP offsets) and
    pass 2 (the SP offsets and a (D, 361) f_init)."""
    wedges, stacked, nr = _stacked(case, 30.0, flooded=True)
    d = len(wedges)
    nr_t = torch.tensor(nr, dtype=torch.int32)
    goff, f_init = _sp_offsets(d, 3)
    passes = ([{"g_offset": goff}, {"g_offset": goff, "f_init": f_init}]
              if sp else [{}])
    for pkw in passes:
        want = []
        for k, lay in enumerate(wedges):
            kw = {n: jnp.asarray(v[k]) for n, v in pkw.items()}
            want.append(np.asarray(marker_state_pallas(
                lay, jnp.asarray(nr, jnp.int32), interpret=True,
                **kw))[:BINS, :6])
        want = np.stack(want)
        got = marker_state(stacked, nr_t, wedges=d, **{
            n: torch.from_numpy(v) for n, v in pkw.items()})
        assert got.shape == (d, BINS, 6) and got.dtype == torch.float32
        _assert_state(got.numpy(), want)
        if case == "empty":
            assert not want[2, :, 1:].any()
        if case in ("plain", "rings5"):
            assert (want[..., 1] > 0).sum() > 10


@pytest.mark.parametrize("case", CASES)
def test_marker_state_wedges_vs_xla_markers(case):
    """The markers of the wedge-axis state (exists = maxd > 0, x, y, z,
    red = f below 3e38) equal the eager XLA ops/markers.marker_points of
    each wedge, bit for bit."""
    wedges, stacked, nr = _stacked(case, 30.0, flooded=True)
    st = marker_state(stacked, torch.tensor(nr, dtype=torch.int32),
                      wedges=len(wedges)).numpy()
    for k, lay in enumerate(wedges):
        want = np.asarray(jmarkers(lay, jnp.asarray(nr, jnp.int32)))
        got = np.stack([(st[k, :, 1] > 0).astype(F32), st[k, :, 3],
                        st[k, :, 4], st[k, :, 5],
                        (st[k, :, 0] < F32(F_NONE)).astype(F32),
                        np.arange(BINS, dtype=F32)], axis=1)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES)
def test_marker_state_wedges_equal_2d_calls(case):
    """The wedge axis equals the per-wedge 2-D calls stacked, with the
    default offsets and with the SP offsets and a broadcast f_init view."""
    wedges, stacked, nr = _stacked(case, 30.0, flooded=True)
    d = len(wedges)
    nr_t = torch.tensor(nr, dtype=torch.int32)
    ports = [layout_from_numpy(lay) for lay in wedges]
    got = marker_state(stacked, nr_t, wedges=d)
    assert torch.equal(got, torch.stack([marker_state(p, nr_t)
                                         for p in ports]))
    goff, f_init = _sp_offsets(d, 5)
    goff_t = torch.from_numpy(goff)
    floor = torch.from_numpy(f_init[0])
    got = marker_state(stacked, nr_t, goff_t, floor.expand(d, BINS),
                       wedges=d)
    want = torch.stack([marker_state(p, nr_t, goff_t[k], floor)
                        for k, p in enumerate(ports)])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# --- K8's rule as a numpy model -------------------------------------------


def model_blocked(alpha, label, counts, w, bz, rings):
    """(rows, 362) x 2 blocked bits by the kernel's rule."""
    rows, p = alpha.shape
    bz = F32(bz)
    edge = F32(F32(360.0) - bz)
    starts = np.arange(STARTS)
    bf = np.zeros((rows, STARTS), bool)
    bb = np.zeros((rows, STARTS), bool)
    with np.errstate(invalid="ignore", over="ignore"):
        for row in range(rows):
            k = row % rings
            wk = F32(w[k])
            n = min(max(int(counts[row]), 0), p)
            a = alpha[row, :n][(label[row, :n] == LABEL_CURB)
                               & ~np.isnan(alpha[row, :n])]
            # The smallest curb azimuth per top start (floor(a), 361 for
            # a >= 361) and the largest per first start (ceil(a), 0 for
            # a <= 0), with a flag for "some curb".
            lo = np.full(STARTS, np.inf, F32)
            hi = np.full(STARTS, -np.inf, F32)
            has_lo = np.zeros(STARTS, bool)
            has_hi = np.zeros(STARTS, bool)
            for v in a:
                if v >= 0:
                    top = 361 if v >= 361 else int(np.floor(v))
                    lo[top] = min(lo[top], v)
                    has_lo[top] = True
                if v <= 361:
                    first = 0 if v <= 0 else int(np.ceil(v))
                    hi[first] = max(hi[first], v)
                    has_hi[first] = True
            # The nearest curb at or after each start (a suffix minimum over
            # the tops), and at or before it (a prefix maximum over the
            # firsts).
            nxt = np.minimum.accumulate(lo[::-1])[::-1]
            has_nxt = np.logical_or.accumulate(has_lo[::-1])[::-1]
            prv = np.maximum.accumulate(hi)
            has_prv = np.logical_or.accumulate(has_hi)
            i = starts.astype(F32)
            bf[row] = has_nxt & (nxt <= (i + wk).astype(F32))
            bb[row] = has_prv & ((i - wk).astype(F32) <= prv)
            if k >= 1 and 0 <= edge <= 361 and edge == np.floor(edge):
                bf[row, int(edge)] = bool(((edge <= a) & (a <= 360)).any())
            if k >= 1 and 0 <= bz <= 361 and bz == np.floor(bz):
                bb[row, int(bz)] = bool(((0 <= a) & (a <= bz)).any())
    return bf, bb


def _layout(alpha, label, counts):
    r, p = alpha.shape
    zf = torch.zeros((r, p), dtype=torch.float32)
    return RingLayout(x=zf, y=zf, z=zf, d2=zf,
                      alpha=torch.from_numpy(np.ascontiguousarray(alpha, F32)),
                      label=torch.from_numpy(label.astype(np.int32)),
                      pid=torch.full((r, p), -1, dtype=torch.int32),
                      counts=torch.from_numpy(counts.astype(np.int32)),
                      overflow=torch.zeros((), dtype=torch.int32))


def _assert_blocked_model(alpha, label, counts, w, bz, d):
    rings = len(w)
    got = bs.flood_blocked_plain(_layout(alpha, label, counts),
                                 torch.from_numpy(np.asarray(w, F32)), bz,
                                 wedges=d)
    want = model_blocked(alpha, label, counts, w, bz, rings)
    for g, wt in zip(got, want):
        np.testing.assert_array_equal(g.numpy().reshape(-1, STARTS), wt)
    return want


def _edge_rows(wk, d, seed=0):
    """d wedges of 4 rings of width wk: curb azimuths at every integer
    start, at fl(i +- wk) and one ulp either side, at -0.0, 360, 361,
    +-inf, NaN, just outside [0, 360] and in [-10, 370]; the last ring of
    each wedge counts half its slots."""
    i = np.arange(STARTS, dtype=F32)
    with np.errstate(invalid="ignore", over="ignore"):
        ends = [i + F32(wk), i - F32(wk)]
    ends = [v for e in ends for v in (e, np.nextafter(e, F32(np.inf)),
                                      np.nextafter(e, F32(-np.inf)))]
    rng = np.random.default_rng(seed)
    row = np.concatenate([i, np.nextafter(i, F32(np.inf)),
                          np.nextafter(i, F32(-np.inf)), *ends,
                          np.array([-0.0, 360.0, 361.0, np.inf, -np.inf,
                                    np.nan, -1e-3,
                                    np.nextafter(F32(360), F32(400))], F32),
                          rng.uniform(-10, 370, 64).astype(F32)])
    alpha = np.tile(row.astype(F32), (4 * d, 1))
    p = alpha.shape[1]
    counts = np.tile([p, p, p, p // 2], d)
    label = np.where(rng.random((4 * d, p)) < 0.1, LABEL_CURB, 0)
    return alpha, label, counts


@pytest.mark.parametrize("bz", [30.0, 45.5, 0.0, 360.0, 361.0])
@pytest.mark.parametrize("wk", WIDTHS)
def test_blocked_model_on_window_edges(wk, bz):
    alpha, label, counts = _edge_rows(wk, 2)
    bf, bb = _assert_blocked_model(alpha, label, counts,
                                   [bz, wk, wk, wk], bz, 2)
    if np.isfinite(wk) and wk >= 1:
        assert bf[1:4].any() and bb[1:4].any()


@pytest.mark.parametrize("d", [1, 3])
def test_blocked_model_all_curbs(d):
    """Every valid slot a curb (the kernel's worst case)."""
    alpha, _, counts = _edge_rows(37.5, d, seed=4)
    label = np.full(alpha.shape, LABEL_CURB)
    bf, _ = _assert_blocked_model(alpha, label, counts,
                                  [30.0, 37.5, 5.0, 1e-30], 30.0, d)
    assert bf.all(axis=1)[1:3].all()


@settings(max_examples=60, deadline=None, database=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1),
       wk=st.one_of(st.sampled_from(WIDTHS),
                    st.floats(-400.0, 400.0, width=32),
                    st.floats(width=32)),
       bz=st.one_of(st.sampled_from([30.0, 45.5, 0.0, 180.0, 359.0, 360.0,
                                     361.0, 12.25, -0.0]),
                    st.floats(-1.0, 362.0, width=32)),
       density=st.sampled_from([0.02, 0.3, 1.0]),
       d=st.integers(1, 3))
def test_blocked_model_sweep(seed, wk, bz, density, d):
    """Random curbs on and beside random window ends, random widths and
    beam zones (360 - bz an integer or not), azimuths in [-10, 370]: the
    model equals the dense twin."""
    rng = np.random.default_rng(seed)
    r, p = 3, 40
    w = np.array([bz, wk, rng.uniform(0, 50)], F32)
    start = rng.integers(0, STARTS, (d * r, p)).astype(F32)
    wr = np.tile(w, d)[:, None]
    with np.errstate(invalid="ignore", over="ignore"):
        fwd, bwd = start + wr, start - wr
    pick = rng.integers(0, 5, (d * r, p))
    odd = rng.choice(np.array([np.nan, np.inf, -np.inf, -0.0, 361.0], F32),
                     (d * r, p))
    alpha = np.choose(pick, [start, fwd, bwd,
                             rng.uniform(-10, 370, (d * r, p)).astype(F32),
                             odd])
    nudge = rng.integers(-1, 2, (d * r, p))
    alpha = np.where(nudge > 0, np.nextafter(alpha, F32(np.inf)),
                     np.where(nudge < 0, np.nextafter(alpha, F32(-np.inf)),
                              alpha)).astype(F32)
    label = np.where(rng.random((d * r, p)) < density, LABEL_CURB,
                     rng.integers(0, 2, (d * r, p)))
    _assert_blocked_model(alpha, label, rng.integers(-1, p + 2, d * r), w,
                          float(bz), d)


# --- K14's three phases as a numpy model ----------------------------------


def model_state(lay, nr, goff, f_init, d, groups, step):
    """(D, 361, 6) by the kernel's phases: rings j, j + groups, ... of a
    wedge form row group j; phase 2 walks a group's slots ``step`` at a
    time."""
    x, y, z = (getattr(lay, f).numpy() for f in ("x", "y", "z"))
    alpha, label = lay.alpha.numpy(), lay.label.numpy()
    counts = lay.counts.numpy()
    rows, p = alpha.shape
    r = rows // d
    dist = np.sqrt(x * x + y * y)
    nokey = np.iinfo(np.int64).max
    out = np.zeros((d, BINS, 6), F32)
    with np.errstate(invalid="ignore"):
        for w in range(d):
            slots = []  # per group: (bin, g, flat, road, dist) of its slots
            for j in range(groups):
                sl = []
                for k in range(j, min(nr, r), groups):
                    row = w * r + k
                    n = min(max(int(counts[row]), 0), p)
                    for s in range(n):
                        a = alpha[row, s]
                        if 0 <= a <= 360:
                            sl.append((int(np.floor(a)),
                                       int(goff[row]) + s, row * p + s,
                                       label[row, s] == 1, dist[row, s]))
                slots.append(sl)
            # Phase 1, each group's partials starting from f_init, and
            # phase 2's merge of f.
            part_f = np.tile(f_init[w].astype(F32), (groups, 1))
            for j, sl in enumerate(slots):
                for b, g, _, road, _ in sl:
                    if not road:
                        part_f[j, b] = min(part_f[j, b], F32(g))
            f = part_f.min(0)
            # Phase 2: per group, in steps.
            part = []
            for sl in slots:
                maxd = np.zeros(BINS, F32)
                key = np.full(BINS, nokey, np.int64)
                for c in range(0, len(sl), step):
                    chunk = [t for t in sl[c:c + step]
                             if t[3] and t[4] > 0 and F32(t[1]) < f[t[0]]]
                    new = maxd.copy()
                    for b, _, _, _, dd in chunk:
                        new[b] = max(new[b], dd)
                    key[new != maxd] = nokey
                    maxd = new
                    for b, g, flat, _, dd in chunk:
                        if dd == maxd[b]:
                            key[b] = min(key[b], (g << 32) | flat)
                part.append((maxd, key))
            # Phase 3.
            for b in range(BINS):
                bd, bk = F32(0), nokey
                for maxd, key in part:
                    if maxd[b] > bd or (maxd[b] == bd and key[b] < bk):
                        bd, bk = maxd[b], key[b]
                row = [f[b], 0, 0, 0, 0, 0]
                if bd > 0:
                    at = bk & 0xFFFFFFFF
                    row[1:] = [bd, F32(bk >> 32), x.flat[at], y.flat[at],
                               z.flat[at]]
                out[w, b] = row
    return out


def _tie_wedges():
    """Three wedges of 4 rings x 16 slots: equal distances in one bin on
    different rings (so in different row groups) and in one ring across
    steps; g offsets that make equal g on two rings (the flat slot
    decides); a non-road point cutting a bin short; wedge 2 empty."""
    d, r, p = 3, 4, 16
    x = np.zeros((d * r, p), F32)
    y = np.zeros((d * r, p), F32)
    lab = np.ones((d * r, p), I32)
    counts = np.full(d * r, p)
    counts[8:] = 0
    rng = np.random.default_rng(2)
    for row in range(8):
        deg = np.sort(rng.uniform(10, 13, p))
        rad = rng.choice(np.array([3.0, 5.0, 5.0, 4.0], F32), p)
        x[row] = rad * np.cos(np.radians(90 - deg))
        y[row] = -rad * np.sin(np.radians(90 - deg))
    lab[5, 9] = 0  # a non-road point
    d2, alpha = azimuth_2d(torch.from_numpy(x), torch.from_numpy(y))
    lay = RingLayout(
        x=torch.from_numpy(x), y=torch.from_numpy(y),
        z=torch.from_numpy(rng.normal(size=(d * r, p)).astype(F32)),
        d2=d2, alpha=alpha, label=torch.from_numpy(lab),
        pid=torch.full((d * r, p), -1, dtype=torch.int32),
        counts=torch.from_numpy(counts.astype(I32)),
        overflow=torch.zeros((), dtype=torch.int32))
    goff = np.array([[0, 0, 16, 16]] * d, I32)  # rings 0 and 1 share g
    return lay, d, r, goff


@pytest.mark.parametrize("groups,step", [(1, 1000), (2, 3), (4, 1),
                                         (3, 7)])
def test_marker_state_model_ties(groups, step):
    lay, d, r, goff = _tie_wedges()
    nr = torch.tensor(r, dtype=torch.int32)
    f_init = np.full((d, BINS), F32(F_NONE))
    want = marker_state_plain(lay, nr, torch.from_numpy(goff),
                              torch.from_numpy(f_init), wedges=d).numpy()
    got = model_state(lay, r, goff.reshape(-1), f_init, d, groups, step)
    np.testing.assert_array_equal(got, want)
    assert (want[:2, 10:13, 1] > 0).all()
    assert not want[2, :, 1:].any()


@pytest.mark.parametrize("groups,step", [(1, 4096), (3, 64), (16, 5)])
@pytest.mark.parametrize("case", ["plain", "nan", "rings5"])
def test_marker_state_model_on_wedges(case, groups, step):
    """The model on the stacked SP layouts, pass 2's f_init and the SP
    offsets."""
    _, stacked, nr = _stacked(case, 30.0, flooded=True)
    d = stacked.alpha.shape[0] // RINGS
    goff, f_init = _sp_offsets(d, 7)
    nr_t = torch.tensor(nr, dtype=torch.int32)
    want = marker_state_plain(stacked, nr_t, torch.from_numpy(goff),
                              torch.from_numpy(f_init), wedges=d).numpy()
    got = model_state(stacked, nr, goff.reshape(-1), f_init, d, groups,
                      step)
    np.testing.assert_array_equal(got, want)
