"""The plain twins of the port's K12, K13 and K14, and of the pieces the
azimuth-sharded path adds (the per-ring azimuth sort, K7's newY ladder
offset, the unfused flood fill), against the JAX functions they replace,
on the CPU, with seeded numpy inputs.

Tolerances: every twin is held bit-equal to the EAGER JAX (XLA) function
of the same inputs.  Against an interpreted Pallas kernel the flood and
marker-key passes are compares only, so they are held exactly as well;
K14's state computes d = sqrt(x*x + y*y) inside the kernel, and
interpreted Pallas on the CPU may contract that into a fused multiply-add
(PERF.md, K1), so its maxd column is held within one ulp and, where the
two agree exactly, the rest of the row bit for bit.

The edge cases are those of tests/test_pallas_interpret.py: NaN azimuths,
empty and one-point rings, num_rings 0 and 1, equal-distance ties.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from urban_road_filter_tpu.config import FilterConfig as JaxConfig
from urban_road_filter_tpu.constants import LABEL_CURB
from urban_road_filter_tpu.io.synthetic import SCENES, make_scan
from urban_road_filter_tpu.ops import blind_spots as jbs
from urban_road_filter_tpu.ops import geometry as jgeo
from urban_road_filter_tpu.ops.flood_scan import labeled_pallas
from urban_road_filter_tpu.ops.marker_scan import (
    marker_points_unsorted_pallas, marker_state_pallas)
from urban_road_filter_tpu.ops.markers import marker_points as jmarkers
from urban_road_filter_tpu.ops.star import star_shaped
from urban_road_filter_tpu.ops.xzero import _new_y_table
from urban_road_filter_tpu.ops.xzero import x_zero as jx_zero
from urban_road_filter_tpu.oracle.reference import (
    azimuth_2d as oracle_azimuth_2d)
from urban_road_filter_torch.convert import filter_config, layout_from_numpy
from urban_road_filter_torch.ops import blind_spots as bs
from urban_road_filter_torch.ops import geometry
from urban_road_filter_torch.ops.marker_state import (
    F_NONE, marker_state, marker_state_plain)
from urban_road_filter_torch.ops.markers import (
    first_nonroad_keys, marker_first_nonroad, marker_points)
from urban_road_filter_torch.ops.stencil_kernels import fused_xz_zero
from urban_road_filter_torch.ops.xzero import new_y_ladder, x_zero
from torch_azimuth import assert_azimuth

torch.set_num_threads(1)  # tier-1 runs several pytest workers

F32 = np.float32
I32 = np.int32
RINGS, CAP = 16, 512


@functools.lru_cache(maxsize=None)
def _raw_layout(scene: str, seed: int, bz: float):
    """A JAX layout of one scene with its star marks as curbs (eager JAX
    ops), its ring count and configuration."""
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
                               with_pid=True)
    return layout, nr, cfg


def _edge(layout, nr, case: str):
    """The edge cases: NaN-azimuth curb points on ring 1, an empty ring 2
    and a one-point ring 3, or num_rings 0 / 1."""
    if case == "nan_empty_short":
        x = np.asarray(layout.x).copy()
        y = np.asarray(layout.y).copy()
        lab = np.asarray(layout.label).copy()
        counts = np.asarray(layout.counts).copy()
        x[1, :3] = 0.0
        y[1, :3] = 0.0
        lab[1, :3] = LABEL_CURB
        counts[2], counts[3] = 0, 1
        d2, alpha = jgeo.azimuth_2d(jnp.asarray(x), jnp.asarray(y))
        layout = layout._replace(x=jnp.asarray(x), y=jnp.asarray(y), d2=d2,
                                 alpha=alpha, label=jnp.asarray(lab),
                                 counts=jnp.asarray(counts))
        assert np.isnan(np.asarray(alpha)[1, :3]).all()
    elif case in ("rings0", "rings1"):
        nr = jnp.asarray(int(case[-1]), jnp.int32)
    return layout, nr


CASES = [("two_curbs", 0, 30.0, "plain"), ("blind_spot", 4, 100.0, "plain"),
         ("two_curbs", 1, 45.5, "plain"),  # no exact-equality special
         ("two_curbs", 2, 10.0, "nan_empty_short"),
         ("curb_gap", 7, 30.0, "rings1"), ("two_curbs", 0, 30.0, "rings0")]


def _case(scene, seed, bz, case):
    layout, nr, cfg = _raw_layout(scene, seed, bz)
    layout, nr = _edge(layout, nr, case)
    return layout, nr, cfg


def _port(layout, nr):
    return (layout_from_numpy(layout),
            torch.tensor(int(nr), dtype=torch.int32))


def _reach(layout, nr, cfg):
    """w and the gated reach of both sweeps, eager JAX."""
    alpha, label, counts = layout.alpha, layout.label, layout.counts
    p = alpha.shape[1]
    slot_valid = jnp.arange(p)[None, :] < counts[:, None]
    ring_iota = jnp.arange(alpha.shape[0], dtype=jnp.int32)
    ring_active = (ring_iota < nr)[:, None]
    curb = slot_valid & (label == LABEL_CURB)
    w = jbs.window_widths(jgeo.max_distance(layout), cfg.beam_zone)
    out = []
    for direction in (+1, -1):
        active, lo, hi = jbs.sweep_bounds(w, cfg.beam_zone, direction)
        blocked = jbs.blocked_bits(alpha, curb, lo, hi)
        first = jnp.min(jnp.where(blocked & ring_active, ring_iota[:, None],
                                  alpha.shape[0]), axis=0)
        out.append(((ring_iota[:, None] < first[None, :]) & active[None, :]
                    & ring_active, lo, hi))
    return w, out


@pytest.mark.parametrize("scene,seed,bz,case", CASES)
def test_flood_road_twin(scene, seed, bz, case):
    """K12's twin: bit-equal to the eager labeled_mask of both sweeps and
    to labeled_pallas in interpret mode (compares only: exact)."""
    layout, nr, cfg = _case(scene, seed, bz, case)
    w, ((rf, lo_f, hi_f), (rb, lo_b, hi_b)) = _reach(layout, nr, cfg)
    alpha, counts = layout.alpha, layout.counts
    slot_valid = jnp.arange(alpha.shape[1])[None, :] < counts[:, None]
    a_ok = (slot_valid & jnp.isfinite(alpha) & (alpha >= 0)
            & (alpha <= F32(360)))
    want = np.asarray(jbs.labeled_mask(alpha, a_ok, rf, lo_f, hi_f)
                      | jbs.labeled_mask(alpha, a_ok, rb, lo_b, hi_b))
    interp = np.asarray(labeled_pallas(layout, rf, rb, w, cfg.beam_zone,
                                       interpret=True))
    lay, _ = _port(layout, nr)
    got = bs.flood_road(lay, torch.from_numpy(np.array(rf)),
                        torch.from_numpy(np.array(rb)),
                        torch.from_numpy(np.array(w)), cfg.beam_zone)
    assert got.dtype == torch.bool and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), interp)
    if case == "plain":
        assert want.any()


@pytest.mark.parametrize("scene,seed,bz,case", CASES[:4])
def test_unfused_blind_spots(scene, seed, bz, case):
    """blind_spots(want_marker_f=False) (K8 + K12) against the JAX
    blind_spots' XLA branch: the layout's labels bit for bit, and equal to
    the fused path's (K8 + K9)."""
    layout, nr, cfg = _case(scene, seed, bz, case)
    max_dist = jgeo.max_distance(layout)
    want = np.asarray(jbs.blind_spots(layout, max_dist, nr, cfg).label)
    lay, nr_t = _port(layout, nr)
    md = torch.from_numpy(np.array(max_dist))
    pcfg = filter_config(cfg)
    got = bs.blind_spots(lay, md, nr_t, pcfg, want_marker_f=False)
    np.testing.assert_array_equal(got.label.numpy(), want)
    fused, _ = bs.blind_spots(lay, md, nr_t, pcfg)
    np.testing.assert_array_equal(fused.label.numpy(), want)


def _flooded(scene, seed, bz, case):
    layout, nr, cfg = _case(scene, seed, bz, case)
    layout = jbs.blind_spots(layout, jgeo.max_distance(layout), nr, cfg)
    return layout, nr


@pytest.mark.parametrize("scene,seed,bz,case", CASES)
def test_marker_points_without_kf(scene, seed, bz, case):
    """marker_points(kf=None) (K13, then K10) against
    marker_points_unsorted_pallas(kf=None) in interpret mode: bit-equal
    (keys and gathered coordinates, no arithmetic)."""
    layout, nr = _flooded(scene, seed, bz, case)
    want = np.asarray(marker_points_unsorted_pallas(layout, nr,
                                                    interpret=True))
    lay, nr_t = _port(layout, nr)
    got = marker_points(lay, nr_t)
    np.testing.assert_array_equal(got.numpy(), want)
    kf = marker_first_nonroad(lay, nr_t)
    assert torch.equal(kf, first_nonroad_keys(lay, nr_t))
    np.testing.assert_array_equal(
        marker_points(lay, nr_t, kf).numpy(), want)
    if case == "plain":
        assert want[:, 0].sum() > 10


def _tie_layout():
    """Two road points of ring 0, bin 10, at the same distance; the one
    with the smaller azimuth wins (tests/test_pallas_interpret.py)."""
    r, p = 8, 128
    x = np.zeros((r, p), F32)
    y = np.zeros((r, p), F32)
    lbl = np.zeros((r, p), I32)
    for s, (deg, rad) in enumerate([(10.2, 3.0), (10.8, 5.0), (10.4, 4.0),
                                    (10.5, 5.0)]):
        x[0, s] = rad * np.cos(np.radians(90 - deg))
        y[0, s] = -rad * np.sin(np.radians(90 - deg))
        lbl[0, s] = 1
    counts = np.zeros((r,), I32)
    counts[0] = 4
    d2, alpha = jgeo.azimuth_2d(jnp.asarray(x), jnp.asarray(y))
    return jgeo.RingLayout(
        x=jnp.asarray(x), y=jnp.asarray(y), z=jnp.zeros((r, p), jnp.float32),
        d2=d2, alpha=alpha, label=jnp.asarray(lbl),
        pid=jnp.full((r, p), -1, jnp.int32), counts=jnp.asarray(counts),
        overflow=jnp.asarray(0, jnp.int32)), jnp.asarray(1, jnp.int32)


def _sorted_case(scene, seed, bz, case):
    if scene == "tie":
        layout, nr = _tie_layout()
    else:
        layout, nr = _flooded(scene, seed, bz, case)
    return jgeo.sort_by_azimuth(layout), nr


def _sp_offsets(r, p, seed):
    """SP-style scan-position offsets ring * P_glob + prefix and a global f
    floor (integer positions, some bins 3e38)."""
    rng = np.random.default_rng(seed)
    p_glob = 8 * p + 1
    goff = (np.arange(r) * p_glob + rng.integers(0, 7 * p, r)).astype(I32)
    f_init = np.where(rng.random(361) < 0.3, F32(3e38),
                      rng.integers(0, r * p_glob, 361).astype(F32))
    return goff, f_init.astype(F32)


def _assert_state(got, want):
    """K14 state against the interpreted kernel: f exact, maxd within one
    ulp, the rest of each row exact where maxd agrees."""
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_array_max_ulp(got[:, 1], want[:, 1], maxulp=1)
    same = got[:, 1] == want[:, 1]
    np.testing.assert_array_equal(got[same], want[same])


SORTED_CASES = CASES + [("tie", 0, 0.0, "tie")]


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("scene,seed,bz,case", SORTED_CASES)
def test_marker_state_twin(scene, seed, bz, case, sp):
    """K14's twin against marker_state_pallas in interpret mode, with the
    default offsets and with the SP path's g_offset and f_init."""
    layout, nr = _sorted_case(scene, seed, bz, case)
    r, p = layout.alpha.shape
    kw, pkw = {}, {}
    if sp:
        goff, f_init = _sp_offsets(r, p, seed)
        kw = dict(g_offset=jnp.asarray(goff), f_init=jnp.asarray(f_init))
        pkw = dict(g_offset=torch.from_numpy(goff),
                   f_init=torch.from_numpy(f_init))
    want = np.asarray(marker_state_pallas(layout, nr, interpret=True,
                                          **kw))[:361, :6]
    lay, nr_t = _port(layout, nr)
    got = marker_state(lay, nr_t, **pkw)
    assert got.shape == (361, 6) and got.dtype == torch.float32
    _assert_state(got.numpy(), want)
    if case == "plain" and not sp:
        assert (want[:, 1] > 0).sum() > 10


@pytest.mark.parametrize("scene,seed,bz,case", SORTED_CASES)
def test_marker_state_vs_xla_markers(scene, seed, bz, case):
    """The markers K14's state gives (exists = maxd > 0, x, y, z, red = f
    below 3e38) equal the eager XLA ops/markers.marker_points on the
    sorted layout, bit for bit."""
    layout, nr = _sorted_case(scene, seed, bz, case)
    want = np.asarray(jmarkers(layout, nr))
    lay, nr_t = _port(layout, nr)
    st = marker_state_plain(lay, nr_t).numpy()
    got = np.stack([(st[:, 1] > 0).astype(F32), st[:, 3], st[:, 4], st[:, 5],
                    (st[:, 0] < F32(F_NONE)).astype(F32),
                    np.arange(361, dtype=F32)], axis=1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scene,seed,bz,case", CASES[:4])
def test_sort_by_azimuth(scene, seed, bz, case):
    """sort_by_azimuth (pid carried or not) against the JAX package's: NaN
    azimuths sort after the finite ones, before the padding, and equal
    azimuths keep slot order, so every carried field is bit-equal.  The
    azimuth is recomputed from the sorted x/y: alpha is held bit-equal to
    the port's own azimuth_2d of the sorted x/y and to the oracle's, and
    within two ulp of the JAX one where the two packages' f32 brackets
    agree, the JAX one everywhere within two ulp of the oracle's recipe on
    its own bracket (tests/torch_azimuth.py)."""
    layout, _ = _flooded(scene, seed, bz, case)
    alpha = np.asarray(layout.alpha).copy()
    alpha[0, 1:4] = alpha[0, 5]  # ties
    layout = layout._replace(alpha=jnp.asarray(alpha))
    lay = layout_from_numpy(layout)
    for carry in (True, False):
        want = jgeo.sort_by_azimuth(layout, carry_pid=carry)
        got = geometry.sort_by_azimuth(lay, carry_pid=carry)
        for f in want._fields:
            g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
            if f == "alpha":
                np.testing.assert_array_equal(
                    g, geometry.azimuth_2d(got.x, got.y)[1].numpy())
                assert_azimuth(got.x.numpy(), got.y.numpy(), g, w,
                               oracle_azimuth_2d)
            else:
                np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("cp", [3, 5, 10])
def test_x_zero_ladder_offset(cp):
    """K7's twin with a per-ring newY ladder offset against the JAX x_zero
    given the same newY values (the SP halo path's global positions):
    labels bit for bit; fused_xz_zero with the offset equals it."""
    layout, _, cfg = _raw_layout("two_curbs", 0, 30.0)
    cfg = cfg.replace(curb_points=cp, curb_height=0.05)
    r, p = layout.x.shape
    rng = np.random.default_rng(cp)
    length = 8 * p
    off = rng.integers(-2 * cp, length - p // 2, r).astype(I32)
    table = _new_y_table(length)
    new_y = table[np.clip(off[:, None] + np.arange(p), 0, length - 1)]
    want = np.asarray(jx_zero(layout, cfg, new_y=jnp.asarray(new_y)).label)
    lay = layout_from_numpy(layout)
    pcfg = filter_config(cfg)
    ladder = new_y_ladder(p, torch.from_numpy(off), length)
    np.testing.assert_array_equal(ladder.numpy(), new_y)
    np.testing.assert_array_equal(x_zero(lay, pcfg, ladder).label.numpy(),
                                  want)
    got = fused_xz_zero(lay, pcfg.replace(z_zero_method=False),
                        ladder_offset=torch.from_numpy(off),
                        ladder_len=length)
    np.testing.assert_array_equal(got.label.numpy(), want)
    # No offset: the single-scan ladder, unchanged.
    np.testing.assert_array_equal(
        fused_xz_zero(lay, pcfg.replace(z_zero_method=False)).label.numpy(),
        np.asarray(jx_zero(layout, cfg).label))
