"""The batch path's lane axis on the CPU (the port of the JAX batch's vmap).

After the ingest, pipeline._stages runs once over tensors with a leading
lane axis, and one scan is the same code at B = 1.  Held here, at small
dims (8-12 rings, 384-1024 azimuths, B = 1, 3 and 5, with an empty lane,
a lane under the 30-point gate and lanes of different ring counts):

  * the batched stages bit-equal, field by field, to a loop of the B = 1
    stages over the lanes, and process_batch / packed_scan to process_scan
    lane by lane;
  * process_batch exact or classified against the JAX process_batch_jit
    (the gates of tests/test_torch_batch.py);
  * each batched plain twin (K4, K5, K6, K8 with a window row per lane, K9,
    K10) and the flood glue equal to the per-lane twin;
  * the batched glue reads no tensor value back to the host (a
    TorchDispatchMode over the batch, the twins' own reads aside);
  * one call of each kernel wrapper per batch, at B = 5 and B = 1.

The cases loop inside nine test items, and each item runs all of its
cases and fails naming every case that failed (_each).  The count of nine
is a scheduling workaround, not a fix: under xdist's loadfile schedule the
files are queued by test count, and a count above
tests/test_config_dynamic.py's nine queued this file ahead of it.  In a
6-worker tier-1 run that moved tests/test_config_dynamic.py onto the
worker that had just run tests/test_pipeline_parity.py, which traces the
same JAX key first, so its retrace test saw no retrace.  That order
dependence lies in those two JAX test files and is open.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from torch_ranks import HostReads
from urban_road_filter_tpu.config import FilterConfig as JFilterConfig
from urban_road_filter_tpu.config import PipelineDims as JPipelineDims
from urban_road_filter_tpu.io.synthetic import SCENES, make_scan
from urban_road_filter_tpu.oracle import run_oracle
from urban_road_filter_tpu.pipeline import planarize_batch as jplanarize
from urban_road_filter_tpu.pipeline import process_batch_jit
from urban_road_filter_torch import (
    FilterConfig, PipelineDims, ScanResult, pad_scan, packed_scan,
    planarize_batch, process_batch, process_scan)
from urban_road_filter_torch import pipeline as pl
from urban_road_filter_torch.config import device_config
from urban_road_filter_torch.constants import LABEL_CURB
from urban_road_filter_torch.convert import to_numpy
from urban_road_filter_torch.ops import blind_spots as bs
from urban_road_filter_torch.ops import geometry, ingest, place, rank, star
from urban_road_filter_torch.ops import markers as mk
from urban_road_filter_torch.ops.gather import gather_pack_batch
from test_torch_pipeline import (
    _assert_labels_vs_jax, _assert_markers_vs_jax, _envelope)

torch.set_num_threads(1)  # tier-1 runs several pytest workers

DIMS = PipelineDims(max_points=8192, rings=16, ring_capacity=1024)
JDIMS = JPipelineDims(max_points=8192, rings=16, ring_capacity=1024)
CONFIGS = {"star": FilterConfig(),
           "star_off": FilterConfig(star_shaped_method=False),
           "gate_x1": FilterConfig(x_direction=1, starbeam_filter=True,
                                   beam_zone=45.0)}


def _lanes():
    """Five scans that differ: three scenes at 12, 8 and 6 rings and 512,
    384 and 1024 azimuths, one of 10 points (under the gate) and an empty
    one."""
    return [make_scan(SCENES["two_curbs"](), n_rings=12, n_azimuth=512,
                      seed=7),
            make_scan(SCENES["blind_spot"](), n_rings=8, n_azimuth=384,
                      seed=8),
            np.tile(np.float32([[1, 0, -2, 0]]), (10, 1)),
            make_scan(SCENES["curb_gap"](), n_rings=6, n_azimuth=1024,
                      seed=9),
            np.zeros((0, 4), np.float32)]


@pytest.fixture(scope="module")
def scans():
    return _lanes()


@pytest.fixture(scope="module")
def rows(scans):
    return np.stack([pad_scan(s, DIMS.max_points) for s in scans])


def _batch_of(rows, b):
    """B = 1, 3 and 5 lanes: the first scene alone; two scenes and the
    gated lane; all five."""
    return rows[[0]] if b == 1 else rows[[0, 2, 3]] if b == 3 else rows


def _stage_inputs(pts, cfg):
    """(x, y, z, valid, keys, ring_id, num_rings) of a (B, N, 4) batch, the
    ingest once over it, cfg bound to its device buffer."""
    x, y, z, _ = geometry.xyz_of(pts, "rows", batched=True)
    valid, fk, r_key, ring_id, num_rings, _ = pl._ingest(x, y, z, cfg, DIMS)
    keys = None if fk is None else (fk, r_key)
    return x, y, z, valid, keys, ring_id, num_rings


def _each(cases, check):
    """check(*case) for every case; fails naming each case that failed,
    with its message, not only the first."""
    failed = []
    for case in cases:
        try:
            check(*case)
        except AssertionError as e:
            failed.append(f"case {case}: {e}")
    assert not failed, "\n".join(failed)


def _lane(t, b):
    return None if t is None else (
        tuple(_lane(u, b) for u in t) if isinstance(t, tuple) else t[b:b + 1])


@pytest.mark.parametrize("b", [1, 3, 5])
def test_stages_equal_lane_loop(rows, b):
    """The batched _stages against a loop of the B = 1 stages, one lane at
    a time, on the same ingest outputs, in every configuration: every
    output bit-equal."""
    pts = torch.from_numpy(_batch_of(rows, b))
    _each([(c,) for c in sorted(CONFIGS)],
          lambda cname: _check_stages(pts, b, cname))


def _check_stages(pts, b, cname):
    cfg = device_config(CONFIGS[cname], pts.device)
    inputs = _stage_inputs(pts, cfg)
    got = pl._stages(*inputs, cfg, DIMS)
    assert got[0].shape == (b, DIMS.rings, DIMS.ring_capacity)
    assert got[4].shape == (b, 361, 6) and got[5].shape == (b,)
    for k in range(b):
        one = pl._stages(*(_lane(t, k) for t in inputs), cfg, DIMS)
        for name, u, v in zip(("table", "pos", "counts", "max_dist",
                               "markers", "overflow"), got, one):
            assert u[k].dtype == v[0].dtype, (cname, k, name)
            np.testing.assert_array_equal(
                u[k].numpy(), v[0].numpy(),
                err_msg=f"{cname} lane {k} {name}")


def test_batch_equals_scans(rows):
    """process_batch at B = 5, rows and planes, every configuration,
    against process_scan and packed_scan of each lane: every field of
    every lane bit-equal."""
    _each([(c, layout) for c in sorted(CONFIGS)
           for layout in ("rows", "planar")],
          lambda c, layout: _check_batch_equals_scans(rows, layout,
                                                      CONFIGS[c]))


def _check_batch_equals_scans(rows, layout, cfg):
    pts = rows if layout == "rows" else planarize_batch(rows)
    got = to_numpy(process_batch(torch.from_numpy(pts), cfg, DIMS,
                                 layout=layout, device="cpu"))
    for k, lane in enumerate(rows):
        one = to_numpy(process_scan(torch.from_numpy(lane), cfg, DIMS,
                                    device="cpu"))
        for f in ScanResult._fields:
            np.testing.assert_array_equal(getattr(got, f)[k],
                                          getattr(one, f),
                                          err_msg=f"lane {k} {f}")
        packed, markers, ok, num_rings, overflow = packed_scan(
            torch.from_numpy(lane), cfg, DIMS, device="cpu")
        np.testing.assert_array_equal(
            packed.numpy(), (got.labels[k].astype(np.uint8)
                             | (got.roi[k].astype(np.uint8) << 2)
                             | (got.probably_road[k].astype(np.uint8) << 3)))
        np.testing.assert_array_equal(markers.numpy(), got.markers[k])
        assert (bool(ok), int(num_rings), int(overflow)) == (
            got.ok[k], got.num_rings[k], got.overflow[k])
    assert got.ok.tolist() == [True, True, False, True, False]
    assert len(set(got.num_rings.tolist())) >= 4


def test_matches_jax_batch(rows, scans):
    """process_batch against the JAX process_batch_jit on the same planar
    batch: exact on the ring binning, exact or classified on labels and
    markers."""
    cfg = CONFIGS["star"]
    got = to_numpy(process_batch(torch.from_numpy(planarize_batch(rows)),
                                 cfg, DIMS, layout="planar", device="cpu"))
    jx = ScanResult(*(np.asarray(f) for f in process_batch_jit(
        jplanarize(rows), JFilterConfig(), JDIMS)))
    for f in ("ok", "num_rings", "counts", "overflow", "roi"):
        np.testing.assert_array_equal(getattr(got, f), getattr(jx, f),
                                      err_msg=f)
    assert np.mean(got.ring_id == jx.ring_id) >= 0.9999
    for k in (0, 1, 3):
        orc = run_oracle(scans[k], JFilterConfig())
        env = _envelope(scans[k], JFilterConfig())
        _assert_labels_vs_jax(got.labels[k], jx.labels[k], scans[k],
                              orc.roi_mask, orc, env, f"lane {k} labels")
        _assert_markers_vs_jax(got.markers[k], jx.markers[k], orc, env,
                               f"lane {k} markers")
    for k in (2, 4):  # gated lanes: nothing labelled, no markers
        assert not got.labels[k].any() and not got.markers[k].any()


@pytest.fixture(scope="module")
def probe(rows):
    """The stage inputs of the five-lane batch (star search on), with one
    more lane: the first scan's layout with every slot a curb."""
    cfg = device_config(CONFIGS["gate_x1"], torch.device("cpu"))
    d = {}
    pl._batch_on(torch.from_numpy(rows), cfg, DIMS, "rows", probe=d)
    return d, cfg


def _load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", pathlib.Path(__file__).parents[1] /
        "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# fn on each lane of its tensor and RingLayout arguments through the
# B = 1 forms, stacked (chip_smoke.py's, as phase 2 runs it on the card).
_per_lane = _load_smoke().lanewise


def _same(got, want, what):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want), what
    for k, (u, v) in enumerate(zip(got, want)):
        assert u.shape == v.shape and u.dtype == v.dtype, (what, k)
        np.testing.assert_array_equal(u.numpy(), v.numpy(),
                                      err_msg=f"{what} [{k}]")


def _all_curbs(layout):
    """The layout with one more lane: lane 0 with every slot a curb."""
    cat = {f: torch.cat([getattr(layout, f), getattr(layout, f)[:1]])
           for f in layout._fields if f != "overflow"}
    cat["label"][-1] = LABEL_CURB
    return layout._replace(overflow=torch.cat(
        [layout.overflow, layout.overflow[:1]]), **cat)


def test_star_rank_place_twin_lanes(probe):
    """The batched twins of K4, K5 and K6 (and star_labels, tensorize)
    against the per-lane ones."""
    _each([(_star_twin_lanes,), (_rank_place_twin_lanes,)],
          lambda check: check(probe))


def test_flood_marker_twin_lanes(probe):
    """The batched twins of K8, K9 and K10 and the flood glue against the
    per-lane ones."""
    _each([(_flood_twin_lanes,), (_marker_twin_lanes,)],
          lambda check: check(probe))


def _star_twin_lanes(probe):
    d, cfg = probe
    x, y, z, valid, keys = d["star"]
    fk, r_key = star._star_keys(x, y, z, valid, cfg, keys)
    assert fk.shape == (5, DIMS.max_points)
    hp = star.star_search_plain(fk, r_key, z, cfg)
    _same(hp, _per_lane(star.star_search_plain, fk, r_key, z, cfg), "K4")
    _same(star.star_hits(x, y, z, valid, cfg, keys),
          _per_lane(lambda xs, ys, zs, v, f, r: star.star_hits(
              xs, ys, zs, v, cfg, (f, r)), x, y, z, valid, *keys),
          "star_hits")
    _same(star.star_hits(x, y, z, valid, cfg),  # K1 run here, per lane
          _per_lane(lambda *a: star.star_hits(*a, cfg), x, y, z, valid),
          "star_hits without keys")
    assert (hp[[2, 4]] == 0).all() and hp[0].any()
    ring_id = d["ring_id"]
    pos = rank.group_positions_plain(ring_id, DIMS.rings + 1)[0]
    def labels(hp, ring_id, pos):
        plane = torch.zeros((*hp.shape[:-1], DIMS.rings, DIMS.ring_capacity),
                            dtype=torch.int32)
        return star.star_labels(hp, ring_id, pos, plane)

    _same(labels(hp, ring_id, pos), _per_lane(labels, hp, ring_id, pos),
          "star_labels")


def _rank_place_twin_lanes(probe):
    d, _ = probe
    x, y, z, _, _ = d["star"]
    ring_id = d["ring_id"]
    g = DIMS.rings + 1
    got = rank.group_positions(ring_id, g)
    _same(got, _per_lane(lambda i: rank.group_positions_plain(i, g),
                         ring_id), "K5")
    pos, counts_all = got
    assert counts_all.shape == (5, g) and (counts_all[4, :-1] == 0).all()
    for fields in ((x, y, z), (z,), (x, y)):
        _same(place.group_place(ring_id, pos, counts_all, fields, DIMS.rings,
                                DIMS.ring_capacity),
              _per_lane(lambda i, q, c, *f: place.group_place_plain(
                  i, q, c, f, DIMS.rings, DIMS.ring_capacity),
                  ring_id, pos, counts_all, *fields), f"K6 {len(fields)}")
    # A capacity the scans overflow: each lane counts its own drops.
    small = place.group_place(ring_id, pos, counts_all, (x,), DIMS.rings, 64)
    _same(small, _per_lane(lambda i, q, c, f: place.group_place_plain(
        i, q, c, (f,), DIMS.rings, 64), ring_id, pos, counts_all, x),
        "K6 capacity 64")
    assert small[-1][0] > 0 and small[-1][4] == 0

    def tensorize(*a):
        layout, p, max_dist = geometry.tensorize(*a, DIMS.ring_capacity,
                                                 rings=DIMS.rings)
        assert torch.equal(max_dist, geometry.max_distance(layout))
        return (*layout, p, max_dist)

    _same(tensorize(x, y, z, ring_id),
          _per_lane(tensorize, x, y, z, ring_id), "tensorize")


def _flood_twin_lanes(probe):
    """K8 (a window row per lane), the glue (window widths, quadrant gate,
    reach with each lane's ring count) and K9 against the per-lane calls,
    with a sixth lane whose every slot is a curb."""
    d, cfg = probe
    layout, max_dist = d["stenciled"]
    layout = _all_curbs(layout)
    max_dist = torch.cat([max_dist, max_dist[:1]])
    num_rings = torch.cat([d["num_rings"], d["num_rings"][:1]])
    assert len(set(num_rings.tolist())) >= 4
    bz = cfg.beam_zone
    w = bs.window_widths(max_dist, bz)
    _same(w, _per_lane(lambda m: bs.window_widths(m, bz), max_dist), "w")
    blocked = bs.flood_blocked(layout, w, bz)
    assert blocked[0].shape == (6, DIMS.rings, 362)
    _same(blocked, _per_lane(lambda lay, wk: bs.flood_blocked_plain(
        lay, wk, bz), layout, w), "K8")
    assert blocked[0][5].any() and blocked[1][5].any()
    # The stacked rows with the window rows, and the SP form: a shared row.
    rows = geometry.stacked_rows(layout)
    _same(bs.flood_blocked(rows, w, bz, wedges=6), blocked, "K8 stacked")
    _same(bs.flood_blocked(rows, w[0], bz, wedges=6),
          bs.flood_blocked(rows, w[0].expand(6, DIMS.rings), bz, wedges=6),
          "K8 shared row")
    reach = bs.sweep_reach(layout, blocked, w, num_rings, cfg)
    _same(reach, _per_lane(lambda lay, b0, b1, wk, nr: bs.sweep_reach(
        lay, (b0, b1), wk, nr, cfg), layout, *blocked, w, num_rings),
        "reach")
    got = bs.flood_labeled(layout, *reach, w, bz, num_rings)
    assert got[1].shape == (6, 361)
    _same(got, _per_lane(lambda lay, rf, rb, wk, nr: bs.flood_labeled_plain(
        lay, rf, rb, wk, bz, nr), layout, *reach, w, num_rings), "K9")

    def flood(*a):
        lay, kf = bs.blind_spots(*a, cfg)
        return lay.label, kf

    _same(flood(layout, max_dist, num_rings),
          _per_lane(flood, layout, max_dist, num_rings), "blind_spots")
    with pytest.raises(ValueError):
        bs.blind_spots(layout, max_dist, num_rings, cfg, want_marker_f=False)


def _marker_twin_lanes(probe):
    d, _ = probe
    layout, kf = d["flooded"]
    num_rings = d["num_rings"]
    got = mk.marker_points(layout, num_rings, kf)
    assert got.shape == (5, 361, 6)
    _same(got, _per_lane(mk.marker_points_plain, layout, num_rings, kf),
          "K10")
    assert got[0, :, 0].any() and not got[4, :, 0].any()
    _same(mk.first_nonroad_keys(layout, num_rings),
          _per_lane(mk.first_nonroad_keys, layout, num_rings), "kf")
    _same(mk.first_nonroad_keys(layout, num_rings), kf, "K9's kf")
    # Another ring count per lane: lane 0 cut to 5 rings, lane 3 to 1.
    nr = num_rings.clone()
    nr[0], nr[3] = 5, 1
    _same(mk.marker_points(layout, nr, kf),
          _per_lane(mk.marker_points_plain, layout, nr, kf), "K10 rings")
    _same(mk.marker_points(layout, num_rings),  # kf from the twin of K13
          _per_lane(lambda lay, n: mk.marker_points(lay, n), layout,
                    num_rings), "K10 without kf")


def test_batched_glue_reads_nothing_back(rows):
    """No host read of a tensor value in the batch path (the CPU stand-in
    for a graph capture's refusal) outside the kernels' plain twins, at B
    = 1 and 5."""
    _each([(1,), (5,)], lambda b: _check_no_host_read(rows, b))


def _check_no_host_read(rows, b):
    cfg = FilterConfig()
    pts = torch.from_numpy(_batch_of(rows, b))
    process_batch(pts, cfg, DIMS, device="cpu")
    with HostReads() as mode:
        process_batch(pts, cfg, DIMS, device="cpu")
    glue = [(op, frames[-3:]) for op, frames in mode.seen
            if not any(f.endswith("_plain") for f in frames)]
    assert not glue, (b, glue[:5])


WRAPPERS = [  # (module, attribute, kernel) as the batch path looks them up
    (ingest, "ingest_prep", "ingest_prep"),
    (ingest, "discover_rings", "discover_rings"),
    (ingest, "assign_rings", "assign_rings"),
    (star, "star_search", "star_walk"),
    (geometry, "group_positions", "group_rank"),
    (geometry, "group_place", "group_place"),
    (pl, "fused_xz_zero_", "xz_zero"),
    (bs, "flood_blocked", "flood_blocked"),
    (bs, "flood_labeled", "flood_labeled"),
    (pl, "marker_points", "marker_points"),
]


def test_one_wrapper_call_per_batch(rows, monkeypatch):
    """Each kernel's wrapper is called once per batch (K11 once per 128
    lanes), whatever the lane count; one scan the same at B = 1."""
    def check(b):
        with monkeypatch.context() as mp:
            _check_one_call_per_batch(rows, mp, b)

    _each([(1,), (5,)], check)


def _check_one_call_per_batch(rows, monkeypatch, b):
    calls = dict.fromkeys([k for _, _, k in WRAPPERS] + ["gather_pack"], 0)

    def counted(fn, kernel):
        def call(*a, **k):
            calls[kernel] += 1
            return fn(*a, **k)
        return call

    for mod, name, kernel in WRAPPERS:
        monkeypatch.setattr(mod, name, counted(getattr(mod, name), kernel))
    monkeypatch.setattr(pl, "gather_pack_batch",
                        counted(gather_pack_batch, "gather_pack"))
    monkeypatch.setattr(pl, "gather_pack",
                        counted(pl.gather_pack, "gather_pack"))
    pts = torch.from_numpy(_batch_of(rows, b))
    if b == 1:
        process_scan(pts[0], FilterConfig(), DIMS, device="cpu")
    else:
        process_batch(pts, FilterConfig(), DIMS, device="cpu")
    assert calls == dict.fromkeys(calls, 1), calls
    for k in calls:
        calls[k] = 0
    process_batch(pts, FilterConfig(star_shaped_method=False), DIMS,
                  device="cpu")
    assert calls == {**dict.fromkeys(calls, 1), "star_walk": 0}, calls
