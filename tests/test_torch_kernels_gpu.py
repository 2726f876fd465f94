"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Needs a CUDA device (skips without one).  The same checks as phase 2 of
chip_smoke.py at small shapes: every kernel output bit-equal to its twin's
on the same CUDA tensors; the star search (K4) from unsorted keys also
with buckets past its shared chunk, every beam point in one beam, 60 beams
merged, the sink only, one point per beam and -0.0 / NaN radii; the rank
(K5) at 1 to 2049 groups with ids outside the range; ring discovery (K2)
and assignment (K3) also at
full size (131072 points at B = 1 and 128, 128 rings), placement (K6) and
the marker table (K10) at 64 rings x 4096 and 1023 slots, on the inputs
that stress their designs (K6 and K10 on chip_smoke.py's place_cases and
marker_cases, K9 and K12 on its flood_cases at 64 x 4096 and 128 x 2048,
one launch per call), K8 and K14 over three stacked azimuth wedges (one
launch per call, an empty wedge, NaN azimuths, K14 with and without
f_init), K14 with rows longer than one step (8192 and 8191 slots) and
over more row groups than the card holds blocks at once (64 wedges of 128
x 384), and K8 with every slot a curb; K11 over batches of 1, 3, 128, 129
and 257 lanes (one launch per 128) with indices outside the tables,
mixed gates and lanes off a 4-point boundary; K1 at 1 to 131072 points,
B = 1, 3 and 128, on rows of 4 and 3 floats, rows at storage offsets of
1-3 floats and planes, one device op a call, its in-ROI counts exact over
200 launches alternating B = 1, B = 128 and the SP call's shape (its
first-block tickets); the marker keys (K13) at 64 x 4096, 128 x 2048, one
slot past a row's pass of 2048 slots and of two, and over 4000 rows (2000
blocks, its first-block tickets), one device op a call.  Run on a machine with the
card
(tests/conftest.py imports jax, which a GPU host without JAX skips with
--noconftest):

    python -m pytest tests/test_torch_kernels_gpu.py -q -m gpu --noconftest
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from star_streams import scatter_streams, walk_streams

from urban_road_filter_torch import (
    FilterConfig, PipelineDims, _build, pad_scan, planarize_batch,
    process_batch, process_scan)
from urban_road_filter_torch.io import (
    SCENES, Extrinsics, SceneSpec, make_scan, make_sensor_scan, merge_scans)
from urban_road_filter_torch.ops import geometry, ingest
from urban_road_filter_torch.ops import blind_spots as bs
from urban_road_filter_torch.ops import markers as mk
from urban_road_filter_torch.ops import star
from urban_road_filter_torch.ops.blind_spots import blind_spots
from urban_road_filter_torch.ops.gather import (
    gather_pack, gather_pack_batch, gather_pack_batch_plain, gather_pack_plain)
from urban_road_filter_torch.ops.place import group_place, group_place_plain
from urban_road_filter_torch.ops.rank import (
    group_positions, group_positions_plain)
from urban_road_filter_torch.ops.stencil_kernels import fused_xz_zero
from urban_road_filter_torch.ops.xzero import x_zero
from urban_road_filter_torch.ops.zzero import z_zero

pytestmark = pytest.mark.gpu

RINGS, CAP, N = 64, 1024, 16384


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _build.library()  # builds csrc/*.cu on first use
    return torch.device("cuda", 0)


def _assert_same(got, want):
    """Bit-equal: float outputs compare by their bits, so NaNs must match."""
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)


def _rings(dev, scene="two_curbs", seed=0, cfg=FilterConfig()):
    pts = make_scan(SCENES[scene](), n_rings=24, n_azimuth=384, seed=seed)
    x, y, z, _ = geometry.xyz_of(
        torch.from_numpy(pad_scan(pts, N)).to(dev), "rows")
    x, y, z = x.contiguous(), y.contiguous(), z.contiguous()
    valid = geometry.roi_mask_xyz(x, y, z, cfg)
    _, alpha = geometry.vertical_angles(x, y, z)
    angles, num_rings = geometry.discover_rings(alpha, valid, cfg.interval)
    ring_id = geometry.assign_rings(alpha, valid, angles, cfg.interval)
    return x, y, z, valid, ring_id, num_rings


@pytest.mark.parametrize("seed,max_len", [(0, 300), (1, 3000)])
@pytest.mark.parametrize("kw", [dict(), dict(kdev_param=0.6, dmin_param=3)])
def test_star_walk_kernel(dev, seed, max_len, kw):
    # K4 on the unsorted inputs of the beam-sorted streams; max_len 3000:
    # buckets longer than the kernel's shared chunk (1024 keys).
    cfg = FilterConfig(**kw)
    streams = walk_streams(seed, max_len)
    (fk, r, z), pid = scatter_streams(streams, seed)
    fk, r, z = (torch.from_numpy(a).to(dev) for a in (fk, r, z))
    before = _build.launch_counts()["star_walk"]
    got = star.star_search(fk, r, z, cfg)
    assert _build.launch_counts()["star_walk"] == before + 1
    sorted_ = [torch.from_numpy(a).to(dev) for a in (*streams[:3], pid)]
    _assert_same((got,), (star.star_walk_plain(*sorted_, cfg),))
    _assert_same((got,), (star.star_search_plain(fk, r, z, cfg),))
    assert int((got > 0).sum()) > 30


@pytest.mark.parametrize("kw", [dict(), dict(starbeam_filter=True)])
@pytest.mark.parametrize("scene", ["two_curbs", "wall"])
def test_star_hits_kernel(dev, scene, kw):
    cfg = FilterConfig(**kw)
    x, y, z, valid, _, _ = _rings(dev, scene, cfg=cfg)
    got = star.star_hits(x, y, z, valid, cfg)
    _assert_same((got,), (star.star_walk_plain(
        *star.beam_streams(x, y, z, valid, cfg), cfg),))
    assert int((got > 0).sum()) > 30


def _star_keys(dev, scene="two_curbs"):
    """(fk, r_key, z) of a scan from K1, z a strided rows-layout view."""
    pts = make_scan(SCENES[scene](), n_rings=24, n_azimuth=384, seed=3)
    rows = torch.from_numpy(pad_scan(pts, N)).to(dev)
    x, y, z, _ = geometry.xyz_of(rows, "rows")
    _, fk, r_key, _ = ingest.ingest_prep(x[None], y[None], z[None],
                                         FilterConfig())
    return fk[0], r_key[0], z


@pytest.mark.parametrize("case", ["one beam", "60 merged", "sink only",
                                  "odd radii", "one point per beam"])
def test_star_search_cases(dev, case):
    fk, r, z = _star_keys(dev)
    if case == "one beam":  # every point in the ROI in one bucket
        fk = torch.where(fk < 360, 7, fk)
    elif case == "60 merged":
        fk = torch.where(fk < 360, fk // 60, fk)
    elif case == "sink only":
        fk = torch.full_like(fk, 360)
    elif case == "odd radii":  # -0.0, NaN, ties and negatives in beams
        rng = np.random.default_rng(4)
        pick = torch.from_numpy(rng.integers(0, 5, fk.shape[0])).to(dev)
        odd = torch.tensor([-0.0, float("nan"), 0.0, -1.0, 3.0],
                           device=dev)[pick]
        r = torch.where(torch.from_numpy(rng.random(fk.shape[0]) < 0.3)
                        .to(dev), odd, r)
    else:
        iota = torch.arange(fk.shape[0], device=dev)
        first = torch.full((361,), fk.shape[0], device=dev).scatter_reduce(
            0, fk.long(), iota, "amin")
        fk = torch.where((iota == first[fk.long()]) & (fk < 360), fk, 360)
    got = star.star_search(fk, r, z, FilterConfig())
    _assert_same((got,), (star.star_search_plain(fk, r, z, FilterConfig()),))
    if case in ("sink only", "one point per beam"):
        assert not bool(got.any())


def _rank_ids(n, groups, seed, outside):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, groups, n).astype(np.int32)
    if outside:
        bad = rng.random(n) < 0.1
        ids[bad] = rng.choice(np.array([-1, -7, groups, groups + 3],
                                       np.int32), int(bad.sum()))
    return ids


def _rank_np(ids, groups):
    """pos[i] = # of j < i with ids[j] == ids[i] (-1 outside [0, groups)),
    counts[g] = # of ids == g."""
    pos = np.full(ids.shape, -1, np.int32)
    seen = {}
    for i, g in enumerate(ids.tolist()):
        if 0 <= g < groups:
            pos[i] = seen.get(g, 0)
            seen[g] = pos[i] + 1
    return pos, np.bincount(ids[(ids >= 0) & (ids < groups)],
                            minlength=groups).astype(np.int32)


@pytest.mark.parametrize("n,groups,seed", [
    (300, 5, 0), (4096, 65, 1), (5000, 361, 2), (131072, 65, 3),
    (131072 + 17, 9, 4), (262144 - 5, 129, 5), (262144, 1025, 6),
    (262144 + 3, 2049, 7), (1, 1, 8), (300 * 1024 + 7, 9, 9)])
def test_rank_kernel(dev, n, groups, seed):
    ids = torch.from_numpy(_rank_ids(n, groups, seed, False)).to(dev)
    before = _build.launch_counts()["group_rank"]
    _assert_same(group_positions(ids, groups),
                 group_positions_plain(ids, groups))
    assert _build.launch_counts()["group_rank"] == before + 1


@pytest.mark.parametrize("n,groups", [(5000, 9), (70001, 1025), (9000, 2049)])
def test_rank_kernel_ids_outside(dev, n, groups):
    ids = _rank_ids(n, groups, n, True)
    pos, counts = group_positions(torch.from_numpy(ids).to(dev), groups)
    want_pos, want_counts = _rank_np(ids, groups)
    np.testing.assert_array_equal(pos.cpu().numpy(), want_pos)
    np.testing.assert_array_equal(counts.cpu().numpy(), want_counts)


@pytest.mark.parametrize("cap", [CAP, 64])
def test_place_kernel(dev, cap):
    x, y, z, _, ring_id, _ = _rings(dev)
    pos, counts = group_positions(ring_id, RINGS + 1)
    before = _build.launch_counts()["group_place"]
    got = group_place(ring_id, pos, counts, (x, y, z), RINGS, cap)
    assert _build.launch_counts()["group_place"] == before + 1
    _assert_same(got, group_place_plain(ring_id, pos, counts, (x, y, z),
                                        RINGS, cap))
    assert (int(got[3]) > 0) == (cap == 64)


def _smoke():
    """chip_smoke.py as a module: its K6 and K10 input cases."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", pathlib.Path(__file__).parents[1] /
        "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def os1_64(dev):
    """One emulated OS1-64 drive scan on the card as packed_scan sees it:
    (chip_smoke module, rows (131072, 4), ring ids, num_rings), 64 rings."""
    smoke = _smoke()
    cfg = FilterConfig()
    pts = torch.from_numpy(pad_scan(smoke.os1_64_scan(), 131072)).to(dev)
    x, y, z, _ = geometry.xyz_of(pts, "rows")
    valid = geometry.roi_mask_xyz(x, y, z, cfg)
    _, alpha = geometry.vertical_angles(x, y, z)
    angles, num_rings = geometry.discover_rings(alpha, valid, cfg.interval)
    ring_id = geometry.assign_rings(alpha, valid, angles, cfg.interval)
    return smoke, pts, ring_id, num_rings


@pytest.mark.parametrize("case", range(4))
def test_place_kernel_full_size(dev, os1_64, case):
    """K6 at 131072 points, 64 rings, on chip_smoke's place_cases: one
    launch per call, bit-equal to the twin."""
    smoke, pts, ring_id, _ = os1_64
    pos, counts = group_positions(ring_id, RINGS + 1)
    name, fields, cap = smoke.place_cases(pts, ring_id, pos, RINGS,
                                          4096)[case]
    before = _build.launch_counts()["group_place"]
    got = group_place(ring_id, pos, counts, fields, RINGS, cap)
    assert _build.launch_counts()["group_place"] == before + 1, name
    _assert_same(got, group_place_plain(ring_id, pos, counts, fields, RINGS,
                                        cap))
    assert len(got) == len(fields) + 1
    if cap == 64:
        assert int(got[-1]) > 0, name


@pytest.mark.parametrize("cap", [4096, 1023])
@pytest.mark.parametrize("case", range(5))
def test_marker_kernel_full_size(dev, os1_64, case, cap):
    """K10 at 64 rings x 4096 and 1023 slots on chip_smoke's marker_cases:
    one launch per call, bit-equal to the twin."""
    smoke, pts, ring_id, num_rings = os1_64
    cfg = FilterConfig()
    x, y, z, _ = geometry.xyz_of(pts, "rows")
    layout, _ = geometry.tensorize(x, y, z, ring_id, cap, rings=RINGS)
    layout = fused_xz_zero(layout, cfg)
    road, kf = blind_spots(layout, geometry.max_distance(layout), num_rings,
                           cfg)
    name, lay, nr, c_kf = smoke.marker_cases(road, num_rings, kf)[case]
    before = _build.launch_counts()["marker_points"]
    table = mk.marker_points(lay, nr, c_kf)
    assert _build.launch_counts()["marker_points"] == before + 1, name
    _assert_same((table,), (mk.marker_points_plain(lay, nr, c_kf),))
    if name == "ties":
        assert int(table[:, 0].sum()) > 150  # every bin with points (180)


@pytest.mark.parametrize("cp", [3, 5, 10])
@pytest.mark.parametrize("scene", ["two_curbs", "high_curbs"])
def test_xz_zero_kernel(dev, scene, cp):
    cfg = FilterConfig(curb_points=cp)
    x, y, z, _, ring_id, _ = _rings(dev, scene, cfg=cfg)
    layout, _ = geometry.tensorize(x, y, z, ring_id, CAP, rings=RINGS)
    got = fused_xz_zero(layout, cfg).label
    assert int((got == 2).sum()) > 0
    _assert_same((got,), (z_zero(x_zero(layout, cfg), cfg).label,))


def test_xz_zero_empty_and_short_rings(dev):
    cfg = FilterConfig()
    rng = np.random.default_rng(3)
    ring_id = np.zeros(512, np.int32)
    ring_id[200:203] = 1
    fields = [torch.from_numpy(v).to(dev) for v in (
        rng.standard_normal(512).astype(np.float32),
        rng.standard_normal(512).astype(np.float32),
        (rng.standard_normal(512) * 0.3).astype(np.float32), ring_id)]
    layout, _ = geometry.tensorize(*fields, 512)
    got = fused_xz_zero(layout, cfg).label
    _assert_same((got,), (z_zero(x_zero(layout, cfg), cfg).label,))
    assert int(got[1:].max()) == 0


def _stenciled(dev, scene, cfg):
    x, y, z, _, ring_id, num_rings = _rings(dev, scene, cfg=cfg)
    layout, _ = geometry.tensorize(x, y, z, ring_id, CAP, rings=RINGS)
    layout = fused_xz_zero(layout, cfg)
    return layout, num_rings, bs.window_widths(
        geometry.max_distance(layout), cfg.beam_zone)


@pytest.mark.parametrize("scene,cfg", [
    ("two_curbs", FilterConfig()),
    ("blind_spot", FilterConfig()),
    ("curb_gap", FilterConfig(x_direction=1, beam_zone=45.5)),
    ("wall", FilterConfig(blind_spots=False, beam_zone=10.0)),
])
def test_flood_and_marker_kernels(dev, scene, cfg):
    layout, num_rings, w = _stenciled(dev, scene, cfg)
    bz = cfg.beam_zone
    blocked = bs.flood_blocked(layout, w, bz)
    _assert_same(blocked, bs.flood_blocked_plain(layout, w, bz))
    reach = bs.sweep_reach(layout, blocked, w, num_rings, cfg)
    label, kf = bs.flood_labeled(layout, *reach, w, bz, num_rings)
    _assert_same((label, kf),
                 bs.flood_labeled_plain(layout, *reach, w, bz, num_rings))
    assert int((label == 1).sum()) > 0
    road = layout._replace(label=label)
    table = mk.marker_points(road, num_rings, kf)
    _assert_same((table,), (mk.marker_points_plain(road, num_rings, kf),))
    assert float(table[:, 0].sum()) > 0


def test_flood_and_marker_kernels_empty(dev):
    cfg = FilterConfig()
    layout, num_rings, w = _stenciled(dev, "flat", cfg)
    empty = layout._replace(counts=torch.zeros_like(layout.counts))
    zero = torch.zeros_like(num_rings)
    blocked = bs.flood_blocked(empty, w, cfg.beam_zone)
    assert not any(bool(b.any()) for b in blocked)
    reach = bs.sweep_reach(empty, blocked, w, zero, cfg)
    label, kf = bs.flood_labeled(empty, *reach, w, cfg.beam_zone, zero)
    _assert_same((label, kf), bs.flood_labeled_plain(
        empty, *reach, w, cfg.beam_zone, zero))
    table = mk.marker_points(empty._replace(label=label), zero, kf)
    assert not bool(table[:, :5].any())


@pytest.mark.parametrize("ok", [True, False])
def test_gather_pack_kernel(dev, ok):
    cfg = FilterConfig()
    x, y, z, valid, ring_id, num_rings = _rings(dev, "curb_gap")
    layout, pos = geometry.tensorize(x, y, z, ring_id, CAP, rings=RINGS)
    layout = fused_xz_zero(layout, cfg)
    table = blind_spots(layout, geometry.max_distance(layout), num_rings,
                        cfg)[0].label
    gate = torch.tensor(ok, device=dev)
    _assert_same(gather_pack(table, ring_id, pos, valid, gate, 10),
                 gather_pack_plain(table, ring_id, pos, valid, gate, 10))
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(rng.integers(-5, RINGS + 5, N).astype(
        np.int32)).to(dev)
    slots = torch.from_numpy(rng.integers(-5, CAP + 5, N).astype(
        np.int32)).to(dev)
    _assert_same(gather_pack(table, ids, slots, valid, gate, 10),
                 gather_pack_plain(table, ids, slots, valid, gate, 10))


def test_gather_pack_probably_road_ring_is_rings(dev):
    """probably_road_ring == rings, the ring id of every point without a
    ring: K11 flags no point, as its twin."""
    x, y, z, valid, ring_id, num_rings = _rings(dev, "curb_gap")
    layout, pos = geometry.tensorize(x, y, z, ring_id, CAP, rings=RINGS)
    gate = torch.tensor(True, device=dev)
    got = gather_pack(layout.label, ring_id, pos, valid, gate, RINGS)
    _assert_same(got, gather_pack_plain(layout.label, ring_id, pos, valid,
                                        gate, RINGS))
    assert int((ring_id == RINGS).sum()) > 0 and not bool(got[2].any())
    assert not bool((got[3] & 8).any())


@pytest.fixture(scope="module")
def flood_layouts(dev):
    """{shape: stenciled layout, num_rings} at 64 rings x 4096 slots (an
    OS1-64 drive scan) and 128 x 2048 (a merged multi-LiDAR scan), with
    chip_smoke's flood_cases on each."""
    smoke = _smoke()
    cfg = FilterConfig()
    out = {}
    for name, scan, n, rings, cap in (
            ("64x4096", smoke.os1_64_scan(), 131072, 64, 4096),
            ("128x2048", smoke.multi_lidar_scans()[0], 262144, 128, 2048)):
        pts = torch.from_numpy(pad_scan(scan, n)).to(dev)
        x, y, z, _ = geometry.xyz_of(pts, "rows")
        valid = geometry.roi_mask_xyz(x, y, z, cfg)
        _, alpha = geometry.vertical_angles(x, y, z)
        angles, num_rings = geometry.discover_rings(alpha, valid,
                                                    cfg.interval, rings=rings)
        ring_id = geometry.assign_rings(alpha, valid, angles, cfg.interval)
        layout, _ = geometry.tensorize(x, y, z, ring_id, cap, rings=rings)
        layout = fused_xz_zero(layout, cfg)
        out[name] = smoke.flood_cases(layout, num_rings)
    return out


@pytest.mark.parametrize("case", range(13))
@pytest.mark.parametrize("shape", ["64x4096", "128x2048"])
def test_flood_kernels_on_flood_cases(dev, flood_layouts, shape, case):
    """K9 and K12 at full size on chip_smoke's flood_cases: one launch per
    call, bit-equal to their twins (K9's kf with no pre-fill, call after
    call)."""
    name, lay, rf, rb, w, bz, nr = flood_layouts[shape][case]
    before = _build.launch_counts()
    got = bs.flood_labeled(lay, rf, rb, w, bz, nr)
    road = bs.flood_road(lay, rf, rb, w, bz)
    after = _build.launch_counts()
    assert after["flood_labeled"] == before["flood_labeled"] + 1, name
    assert after["flood_road"] == before["flood_road"] + 1, name
    _assert_same(got, bs.flood_labeled_plain(lay, rf, rb, w, bz, nr))
    _assert_same((road,), (bs.flood_road_plain(lay, rf, rb, w, bz),))
    if name.startswith("none"):
        assert not bool(road.any()), name


def test_wrappers_refuse_bad_inputs(dev):
    ids = torch.zeros(8, dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        group_positions(ids, 4)
    table = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    i32 = torch.zeros(8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # a CPU operand beside CUDA ones
        gather_pack(table, i32, i32.cpu(), i32 > 0,
                    torch.tensor(True, device=dev), 0)
    rows = torch.zeros((2, 8, 4), device=dev)
    with pytest.raises(ValueError):  # x, y, z must share one stride pattern
        ingest.ingest_prep(rows[..., 0], rows[..., 1].contiguous(),
                           rows[..., 2], FilterConfig())
    alpha = torch.zeros((2, 8), device=dev)
    with pytest.raises(ValueError):  # the ring table holds at most 128
        ingest.discover_rings(alpha, alpha > 0, 0.18, 129)


def _batch_rows(dev, n, n_rings, seeds):
    """(B, n, 4) rows of two_curbs / blind_spot scans on the card."""
    scenes = ("two_curbs", "blind_spot")
    return torch.from_numpy(np.stack([pad_scan(make_scan(
        SCENES[scenes[k % 2]](), n_rings=n_rings, n_azimuth=n // n_rings,
        seed=s), n) for k, s in enumerate(seeds)])).to(dev)


def _ingest_vs_twins(x, y, z, cfg, rings):
    """K1-K3 on (B, N) views against their twins; returns the kernels'
    (valid, ring_id, num_rings)."""
    before = _build.launch_counts()
    got = ingest.ingest_prep(x, y, z, cfg)
    _assert_same(got, ingest.ingest_prep_plain(x, y, z, cfg))
    valid = got[0]
    _, alpha = geometry.vertical_angles(x, y, z)
    angles, count = ingest.discover_rings(alpha, valid, cfg.interval, rings)
    _assert_same((angles, count), ingest.discover_rings_plain(
        alpha, valid, cfg.interval, rings))
    ring_id = ingest.assign_rings(alpha, valid, angles, cfg.interval)
    _assert_same((ring_id,), (ingest.assign_rings_plain(
        alpha, valid, angles, cfg.interval),))
    after = _build.launch_counts()
    for k in ("ingest_prep", "discover_rings", "assign_rings"):
        assert after[k] == before[k] + 1, k
    return valid, ring_id, count


@pytest.mark.parametrize("layout", ["rows", "planar"])
def test_ingest_kernels(dev, layout):
    cfg = FilterConfig()
    rows = _batch_rows(dev, N, 32, (0, 1, 2))
    rows[2, 7:100] = 0
    pts = rows if layout == "rows" else rows[..., :3].permute(2, 0, 1)
    pts = pts.contiguous() if layout == "planar" else pts
    x, y, z, _ = geometry.xyz_of(pts, layout, batched=True)
    _, _, count = _ingest_vs_twins(x, y, z, cfg, RINGS)
    assert int(count.min()) > 20
    got = ingest.ingest_prep(x, y, z, cfg, want_star_keys=False)
    assert got[1] is None
    _assert_same((got[0], got[3]), ingest.ingest_prep_plain(
        x, y, z, cfg, want_star_keys=False)[::3])


def _merged_rows(dev, seeds):
    """(B, 262144, 4) rows of bench.py's multi-LiDAR rig on the card: two
    emulated OS1-64 at offset mounts, 2048 firings each, merged."""
    exts = [Extrinsics(x=0.4, y=0.3, z=0.0, yaw_deg=1.5),
            Extrinsics(x=-0.4, y=-0.3, z=-0.05, yaw_deg=-2.0)]
    return torch.from_numpy(np.stack([pad_scan(merge_scans(
        [make_sensor_scan(SceneSpec(), "os1_64", seed=s + k, firings=2048)
         for k in range(2)], exts), 262144) for s in seeds])).to(dev)


def test_ingest_kernels_262k_128_rings(dev):
    cfg = FilterConfig()
    rows = _merged_rows(dev, (70, 72))
    x, y, z, _ = geometry.xyz_of(rows, "rows", batched=True)
    _, ring_id, count = _ingest_vs_twins(x, y, z, cfg, 128)
    assert int(count.min()) > 64  # the tables pass 64 entries
    # K5 then ranks more than 65 groups.
    for b in range(rows.shape[0]):
        _assert_same(group_positions(ring_id[b], 129),
                     group_positions_plain(ring_id[b], 129))


def test_ingest_kernels_all_invalid(dev):
    cfg = FilterConfig()
    rows = _batch_rows(dev, N, 32, (5, 6))
    rows[1] = 0
    x, y, z, _ = geometry.xyz_of(rows, "rows", batched=True)
    valid, ring_id, count = _ingest_vs_twins(x, y, z, cfg, RINGS)
    assert int(count[1]) == 0 and not bool(valid[1].any())
    assert bool((ring_id[1] == RINGS).all())


def test_ingest_kernels_nan_alpha(dev):
    # A valid point whose vertical angle is NaN (x*x + y*y + z*z
    # underflows): it fills every round after it, as the oracle does.
    cfg = FilterConfig(max_z=1.0)
    rows = _batch_rows(dev, N, 32, (3,))
    rows[0, 5] = torch.tensor([1e-25, 0.0, 0.0, 0.0], device=dev)
    x, y, z, _ = geometry.xyz_of(rows, "rows", batched=True)
    _, ring_id, count = _ingest_vs_twins(x, y, z, cfg, RINGS)
    assert int(count[0]) == RINGS and int(ring_id[0, 5]) == RINGS


@pytest.mark.parametrize("cfg", [FilterConfig(),
                                 FilterConfig(star_shaped_method=False)])
def test_batch_lanes_equal_process_scan(dev, cfg):
    dims = PipelineDims(max_points=N, rings=RINGS, ring_capacity=CAP)
    rows = _batch_rows(dev, N, 32, (0, 1, 2))
    planar = torch.from_numpy(planarize_batch(rows.cpu().numpy())).to(dev)
    before = _build.launch_counts()
    got = process_batch(planar, cfg, dims, layout="planar")
    after = _build.launch_counts()
    assert all(after[k] > before[k] for k in ("ingest_prep", "discover_rings",
                                               "assign_rings", "group_rank"))
    for b in range(rows.shape[0]):
        one = process_scan(rows[b], cfg, dims)
        for g, w in zip(got, one):
            _assert_same((g[b],), (w,))


@pytest.mark.parametrize("scene,cfg", [
    ("two_curbs", FilterConfig()),
    ("curb_gap", FilterConfig(x_direction=1, beam_zone=45.5)),
])
def test_flood_road_and_marker_keys_kernels(dev, scene, cfg):
    """K12 and K13 against their twins; the unfused path (K8 + K12, then
    K13 + K10) equals the fused one (K8 + K9, K10)."""
    layout, num_rings, w = _stenciled(dev, scene, cfg)
    bz = cfg.beam_zone
    blocked = bs.flood_blocked(layout, w, bz)
    reach = bs.sweep_reach(layout, blocked, w, num_rings, cfg)
    road = bs.flood_road(layout, *reach, w, bz)
    _assert_same((road,), (bs.flood_road_plain(layout, *reach, w, bz),))
    assert bool(road.any())
    md = geometry.max_distance(layout)
    unfused = blind_spots(layout, md, num_rings, cfg, want_marker_f=False)
    fused, kf = blind_spots(layout, md, num_rings, cfg)
    _assert_same((unfused.label,), (fused.label,))
    keys = mk.marker_first_nonroad(unfused, num_rings)
    _assert_same((keys, keys), (mk.first_nonroad_keys(unfused, num_rings),
                                kf))
    _assert_same((mk.marker_points(unfused, num_rings),),
                 (mk.marker_points(fused, num_rings, kf),))


@pytest.mark.parametrize("sp", [False, True])
def test_marker_state_kernel(dev, sp):
    """K14 on the sorted layout, default and SP-style offsets and floor."""
    from urban_road_filter_torch.ops.marker_state import (
        marker_state, marker_state_plain)

    cfg = FilterConfig()
    layout, num_rings, w = _stenciled(dev, "two_curbs", cfg)
    layout = blind_spots(layout, geometry.max_distance(layout), num_rings,
                         cfg, want_marker_f=False)
    srt = geometry.sort_by_azimuth(layout)
    kw = {}
    if sp:
        rng = np.random.default_rng(6)
        p_glob = 8 * CAP + 1
        goff = np.arange(RINGS) * p_glob + rng.integers(0, 7 * CAP, RINGS)
        f_init = np.where(rng.random(361) < 0.3, 3e38,
                          rng.integers(0, RINGS * p_glob, 361))
        kw = dict(g_offset=torch.from_numpy(goff.astype(np.int32)).to(dev),
                  f_init=torch.from_numpy(f_init.astype(np.float32)).to(dev))
    got = marker_state(srt, num_rings, **kw)
    _assert_same((got,), (marker_state_plain(srt, num_rings, **kw),))
    assert int((got[:, 1] > 0).sum()) > 10


def _wedge_layouts(dev, sort):
    """Three wedges of 64 rings x 1024 slots stacked (scenes two_curbs,
    blind_spot, curb_gap): wedge 1 with NaN-azimuth curb and road slots on
    rings 1 and 3, wedge 2 empty; flooded and sorted by azimuth for K14."""
    cfg = FilterConfig()
    lays = []
    for k, scene in enumerate(("two_curbs", "blind_spot", "curb_gap")):
        layout, num_rings, w = _stenciled(dev, scene, cfg)
        if sort:
            layout = geometry.sort_by_azimuth(blind_spots(
                layout, geometry.max_distance(layout), num_rings, cfg,
                want_marker_f=False))
        if k == 1:
            x, y, label = layout.x.clone(), layout.y.clone(), layout.label
            label = label.clone()
            x[1:4:2, :3] = 0.0
            y[1:4:2, :3] = 0.0
            label[1, :3] = 2
            label[3, :3] = 1
            d2, alpha = geometry.azimuth_2d(x, y)
            assert bool(torch.isnan(alpha[1, :3]).all())
            layout = layout._replace(x=x, y=y, d2=d2, alpha=alpha,
                                     label=label)
        if k == 2:
            layout = layout._replace(counts=torch.zeros_like(layout.counts))
        lays.append(layout)
    stacked = lays[0]._replace(**{f: torch.cat([getattr(lay, f) for lay in
                                                lays]) for f in (
        "x", "y", "z", "d2", "alpha", "label", "pid", "counts")})
    return lays, stacked, num_rings, w


def test_flood_blocked_wedges(dev):
    """K8 over three stacked wedges in one launch against its twin and
    against the 2-D kernel calls stacked; the empty wedge blocks nothing."""
    lays, stacked, _, w = _wedge_layouts(dev, sort=False)
    for bz in (30.0, 45.5):
        before = _build.launch_counts()["flood_blocked"]
        got = bs.flood_blocked(stacked, w, bz, wedges=3)
        assert _build.launch_counts()["flood_blocked"] == before + 1
        _assert_same(got, bs.flood_blocked_plain(stacked, w, bz, wedges=3))
        for i in (0, 1):
            _assert_same((got[i],), (torch.stack(
                [bs.flood_blocked(lay, w, bz)[i] for lay in lays]),))
            assert bool(got[i][0].any()) and not bool(got[i][2].any())


@pytest.mark.parametrize("wedges", [None, 3])
def test_flood_blocked_all_curbs(dev, wedges):
    """K8's worst case: every valid slot of every ring a curb."""
    lays, stacked, _, w = _wedge_layouts(dev, sort=False)
    layout = lays[0] if wedges is None else stacked
    curbs = layout._replace(label=torch.full_like(layout.label, 2))
    got = bs.flood_blocked(curbs, w, 30.0, wedges=wedges)
    _assert_same(got, bs.flood_blocked_plain(curbs, w, 30.0, wedges=wedges))
    assert bool(got[0].any())


@pytest.mark.parametrize("nr", [None, 5])
def test_marker_state_wedges(dev, nr):
    """K14 over three stacked wedges, one launch per call: default offsets
    without f_init, and the SP path's offsets with a (D, 361) f_init and
    with a broadcast view of one floor; against its twin and against the
    2-D kernel calls stacked."""
    from urban_road_filter_torch.ops.marker_state import (
        marker_state, marker_state_plain)

    lays, stacked, num_rings, _ = _wedge_layouts(dev, sort=True)
    if nr is not None:
        num_rings = torch.full_like(num_rings, nr)
    rng = np.random.default_rng(12)
    p_glob = 3 * CAP + 1
    goff = torch.from_numpy((np.arange(RINGS)[None, :] * p_glob + np.array(
        [[0], [700], [1500]])).astype(np.int32)).to(dev)
    floor = np.where(rng.random(361) < 0.3, 3e38,
                     rng.integers(0, RINGS * p_glob, 361)).astype(np.float32)
    floors = torch.from_numpy(np.stack([floor, floor[::-1], floor])).to(dev)
    one = torch.from_numpy(floor).to(dev)
    for kw, per in (({}, lambda k: {}),
                    (dict(g_offset=goff, f_init=floors),
                     lambda k: dict(g_offset=goff[k], f_init=floors[k])),
                    (dict(g_offset=goff, f_init=one.expand(3, 361)),
                     lambda k: dict(g_offset=goff[k], f_init=one))):
        before = _build.launch_counts()["marker_state"]
        got = marker_state(stacked, num_rings, wedges=3, **kw)
        assert _build.launch_counts()["marker_state"] == before + 1
        assert got.shape == (3, 361, 6)
        _assert_same((got,), (marker_state_plain(stacked, num_rings,
                                                 wedges=3, **kw),))
        _assert_same((got,), (torch.stack([marker_state(
            lay, num_rings, **per(k)) for k, lay in enumerate(lays)]),))
        assert int((got[0, :, 1] > 0).sum()) > 10
        assert not bool(got[2, :, 1:].any())



def _dense_sorted(dev, d, r, p, seed):
    """d wedges of r rings x p slots, stacked: each row's azimuths sorted,
    radii from four values (ties in a bin), labels road, unlabelled and
    curb at random, counts from 0 to past p (rows full to the last slot
    among them)."""
    rng = np.random.default_rng(seed)
    rows = d * r
    deg = np.sort(rng.uniform(-2.0, 362.0, (rows, p)), axis=1)
    rad = rng.choice(np.array([3.0, 4.0, 5.0, 5.0], np.float32), (rows, p))
    x = (rad * np.cos(np.radians(90.0 - deg))).astype(np.float32)
    y = (-rad * np.sin(np.radians(90.0 - deg))).astype(np.float32)
    label = rng.choice(np.array([1, 1, 1, 0, 2], np.int32), (rows, p))
    counts = rng.integers(0, p + 3, rows).astype(np.int32)
    counts[::3] = p
    t = lambda a: torch.from_numpy(a).to(dev)
    xt, yt = t(x), t(y)
    d2, alpha = geometry.azimuth_2d(xt, yt)
    return geometry.RingLayout(
        x=xt, y=yt, z=t(rng.normal(size=(rows, p)).astype(np.float32)),
        d2=d2, alpha=alpha, label=t(label),
        pid=torch.full((rows, p), -1, dtype=torch.int32, device=dev),
        counts=t(counts), overflow=torch.zeros((), dtype=torch.int32,
                                               device=dev))


def _floors(dev, d, g_max, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.where(
        rng.random((d, 361)) < 0.3, 3e38,
        rng.integers(0, g_max, (d, 361))).astype(np.float32)).to(dev)



@pytest.mark.parametrize("p", [8192, 8191])
def test_flood_blocked_long_rows(dev, p):
    """K8 with rows longer than the kernel stages at once (8192 and 8191
    slots), over two stacked wedges; also with alpha and label 4 bytes off
    16-byte alignment (element-wise copies in place of 16-byte ones)."""
    r = 8
    lay = _dense_sorted(dev, 2, r, p, seed=p + 1)
    w = torch.tensor([np.nan, 0.0, 1e-30, 2.5, 17.0, 40.0, np.inf, 361.0],
                     dtype=torch.float32, device=dev)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        buf[1:] = t.reshape(-1)
        return buf[1:].view(t.shape)

    off = lay._replace(alpha=shifted(lay.alpha), label=shifted(lay.label))
    for bz in (30.0, 45.5):
        want = bs.flood_blocked_plain(lay, w, bz, wedges=2)
        for case in (lay, off):
            _assert_same(bs.flood_blocked(case, w, bz, wedges=2), want)
        assert bool(want[0].any()) and not bool(want[0].all())


@pytest.mark.parametrize("floor", [False, True])
@pytest.mark.parametrize("p", [8192, 8191])
def test_marker_state_multi_step_rows(dev, p, floor):
    """K14 with rows longer than one step of a block (ring_capacity 8192,
    and 8191, whose rows are not 16-byte aligned): each row group walks
    its slots in steps and reads them again after the grid barrier; with
    f_init=None and with a given f_init."""
    from urban_road_filter_torch.ops.marker_state import (
        marker_state, marker_state_plain)

    r = 8
    lay = _dense_sorted(dev, 1, r, p, seed=p)
    for nr in (r, r - 3):
        num_rings = torch.tensor(nr, dtype=torch.int32, device=dev)
        kw = dict(f_init=_floors(dev, 1, r * p, nr)[0]) if floor else {}
        got = marker_state(lay, num_rings, **kw)
        _assert_same((got,), (marker_state_plain(lay, num_rings, **kw),))
        assert int((got[:, 1] > 0).sum()) > 150


@pytest.mark.parametrize("floor", [False, True])
def test_marker_state_wedges_past_the_grid(dev, floor):
    """K14 over 64 wedges of 128 x 384 (832 row groups, more than the
    blocks the card holds at once): blocks stride over the groups and read
    their slots again after the grid barrier; the SP path's offsets, with
    f_init=None and with a (D, 361) f_init; against the twin and against
    the 2-D kernel calls stacked."""
    from urban_road_filter_torch.ops.marker_state import (
        marker_state, marker_state_plain)

    d, r, p = 64, 128, 384
    lay = _dense_sorted(dev, d, r, p, seed=11)
    num_rings = torch.tensor(r - 5, dtype=torch.int32, device=dev)
    p_glob = d * p + 1
    goff = torch.from_numpy((np.arange(r)[None, :] * p_glob + np.arange(
        d)[:, None] * p).astype(np.int32)).to(dev)
    kw = dict(g_offset=goff)
    if floor:
        kw["f_init"] = _floors(dev, d, r * p_glob, 5)
    before = _build.launch_counts()["marker_state"]
    got = marker_state(lay, num_rings, wedges=d, **kw)
    assert _build.launch_counts()["marker_state"] == before + 1
    _assert_same((got,), (marker_state_plain(lay, num_rings, wedges=d,
                                             **kw),))
    rows = lambda k: lay._replace(**{f: getattr(lay, f)[k * r:(k + 1) * r]
                                     for f in ("x", "y", "z", "d2", "alpha",
                                               "label", "pid", "counts")})
    for k in (0, 37, d - 1):
        one = dict(g_offset=goff[k])
        if floor:
            one["f_init"] = kw["f_init"][k]
        _assert_same((got[k],), (marker_state(rows(k), num_rings, **one),))
    assert int((got[:, :, 1] > 0).sum()) > d * 150


def test_xz_zero_ladder_kernel(dev):
    """K7 with a per-ring newY ladder offset against its twin."""
    from urban_road_filter_torch.ops.xzero import new_y_ladder

    cfg = FilterConfig(curb_points=5, z_zero_method=False)
    x, y, z, _, ring_id, _ = _rings(dev, "two_curbs", cfg=cfg)
    layout, _ = geometry.tensorize(x, y, z, ring_id, CAP, rings=RINGS)
    rng = np.random.default_rng(8)
    length = 8 * CAP
    off = torch.from_numpy(rng.integers(-10, length, RINGS).astype(
        np.int32)).to(dev)
    got = fused_xz_zero(layout, cfg, ladder_offset=off, ladder_len=length)
    want = x_zero(layout, cfg, new_y_ladder(CAP, off, length))
    _assert_same((got.label,), (want.label,))


@pytest.mark.parametrize("cfg", [FilterConfig(),
                                 FilterConfig(star_shaped_method=False)])
def test_sp_equals_process_scan(dev, cfg):
    """The 8-wedge SP path on an azimuth-sorted scan equals process_scan
    on every field; K8 and K14 launch once per pass over all wedges, K12
    once per wedge."""
    from urban_road_filter_torch.parallel.azimuth_parallel import (
        azimuth_sorted, make_azimuth_pipeline)

    dims = PipelineDims(max_points=8192, rings=RINGS, ring_capacity=CAP)
    scan = azimuth_sorted(make_scan(SCENES["two_curbs"](), n_rings=16,
                                    n_azimuth=384, seed=11))
    pts = torch.from_numpy(pad_scan(scan, dims.max_points)).to(dev)
    _build.reset_launch_counts()
    got = make_azimuth_pipeline(8, cfg, dims)(pts)
    counts = _build.launch_counts()
    assert counts["flood_road"] == 8 and counts["marker_state"] == 2
    assert counts["flood_blocked"] == 1
    want = process_scan(pts, cfg, dims)
    for g, w in zip(got, want):
        _assert_same((g,), (w,))


# --- K2 and K3 on the inputs that stress their designs (csrc/ingest.cu) ---

FULL = 131072  # an OS1-64 scan: 64 rings x 2048 azimuths


def _scan_alpha(dev, ring_major=False, seed=0, n_az=2048, nan_at=()):
    """(alpha, valid) of one 64-ring scan on the card, azimuth-major or
    reordered ring-major (K2's worst case); NaN-angle points at nan_at
    (FilterConfig(max_z=1.0) keeps them valid)."""
    pts = make_scan(SCENES["two_curbs"](), n_rings=64, n_azimuth=n_az,
                    seed=seed)
    if ring_major:
        pts = np.ascontiguousarray(
            pts.reshape(n_az, 64, 4).transpose(1, 0, 2).reshape(-1, 4))
    for i in nan_at:
        pts[i] = (1e-25, 0.0, 0.0, 0.0)
    x, y, z, _ = geometry.xyz_of(torch.from_numpy(pts).to(dev), "rows")
    x, y, z = x.contiguous(), y.contiguous(), z.contiguous()
    cfg = FilterConfig(max_z=1.0) if nan_at else FilterConfig()
    _, alpha = geometry.vertical_angles(x, y, z)
    return alpha, geometry.roi_mask_xyz(x, y, z, cfg)


def _discover_vs_twin(alpha, valid, rings, interval=0.18):
    """K2 against its twin: one launch, no torch.sort; returns (angles,
    count, grid)."""
    before = _build.launch_counts()["discover_rings"]
    angles, count = ingest.discover_rings(alpha, valid, interval, rings)
    assert _build.launch_counts()["discover_rings"] == before + 1
    _assert_same((angles, count), ingest.discover_rings_plain(
        alpha, valid, interval, rings))
    return angles, count, ingest.last_grid["discover_rings"]


def _assign_vs_twin(alpha, valid, angles, interval=0.18):
    ring = ingest.assign_rings(alpha, valid, angles, interval)
    _assert_same((ring,), (ingest.assign_rings_plain(
        alpha, valid, angles, interval),))
    return ring


@pytest.mark.parametrize("ring_major", [False, True])
def test_discover_b1_spreads_over_the_card(dev, ring_major, monkeypatch):
    alpha, valid = _scan_alpha(dev, ring_major)

    def no_sort(*a, **k):
        raise AssertionError("discover_rings must not call torch.sort")

    sort = torch.sort
    monkeypatch.setattr(torch, "sort", no_sort)
    angles, count = ingest.discover_rings(alpha[None], valid[None], 0.18, 64)
    monkeypatch.setattr(torch, "sort", sort)
    segs, b = ingest.last_grid["discover_rings"]
    assert b == 1 and segs > 1  # more than one block for one scan
    _assert_same((angles, count), ingest.discover_rings_plain(
        alpha[None], valid[None], 0.18, 64))
    assert int(count[0]) > 40
    _assign_vs_twin(alpha[None], valid[None], angles)


def test_discover_and_assign_b128(dev):
    # 128 scans: azimuth-major and ring-major 64-ring scans, each rolled by
    # its own offset so that every lane's greedy differs.
    base = [_scan_alpha(dev, rm, seed=s) for s in (0, 1) for rm in (0, 1)]
    alpha = torch.stack([torch.roll(base[k % 4][0], 997 * k)
                         for k in range(128)])
    valid = torch.stack([torch.roll(base[k % 4][1], 997 * k)
                         for k in range(128)])
    angles, count, grid = _discover_vs_twin(alpha, valid, 64)
    assert grid[1] == 128 and int(count.min()) > 40
    _assign_vs_twin(alpha, valid, angles)


@pytest.mark.parametrize("nan_at", [(5,), (70000,), (5, 70000)])
def test_discover_nan_inside_and_after_the_prefix(dev, nan_at):
    alpha, valid = _scan_alpha(dev, nan_at=nan_at)
    angles, count, _ = _discover_vs_twin(alpha[None], valid[None], 64)
    assert int(count[0]) == 64 and bool(torch.isnan(angles[0, -1]))
    ring = _assign_vs_twin(alpha[None], valid[None], angles)
    assert all(int(ring[0, i]) == 64 for i in nan_at)


@pytest.mark.parametrize("rings", [24, 64, 128])
@pytest.mark.parametrize("n", [1000, FULL - 3, FULL])
def test_discover_caps_and_ragged_lengths(dev, rings, n):
    # rings = 24 reaches the cap in the prefix; n < P (1000) and n not a
    # multiple of 32 or 4 (FULL - 3).
    alpha, valid = _scan_alpha(dev)
    a, v = alpha[None, :n].contiguous(), valid[None, :n].contiguous()
    angles, count, _ = _discover_vs_twin(a, v, rings)
    assert 10 < int(count[0]) <= rings
    _assign_vs_twin(a, v, angles)
    # The streams off K3's 16-byte alignment: one point in.
    _assign_vs_twin(alpha[None, 1:n].contiguous(),
                    valid[None, 1:n].contiguous(), angles)


@pytest.mark.parametrize("n", [4097, FULL - 3, FULL])
def test_discover_one_valid_point_at_the_end(dev, n):
    alpha, _ = _scan_alpha(dev)
    valid = torch.zeros((1, n), dtype=torch.bool, device=dev)
    valid[0, -1] = True
    angles, count, _ = _discover_vs_twin(alpha[None, :n].contiguous(),
                                         valid, 64)
    assert int(count[0]) == 1 and bool(torch.isinf(angles[0, 1:]).all())
    angles, count, _ = _discover_vs_twin(alpha[None, :n].contiguous(),
                                         valid & False, 64)
    assert int(count[0]) == 0


@pytest.mark.parametrize("tol", [0.18, 0.25])
def test_tables_exactly_tol_away(dev, tol):
    # Points exactly tol from an entry and one ulp either side; 128 rings.
    t32 = np.float32(tol)
    centres = np.linspace(-20.0, 20.0, 97).astype(np.float32)
    centres[48] = 0.0
    edges = np.concatenate([centres + t32, centres - t32]).astype(np.float32)
    pts = np.concatenate([centres, edges, np.nextafter(edges, np.inf),
                          np.nextafter(edges, -np.inf)]).astype(np.float32)
    pts = np.resize(pts, FULL)
    alpha = torch.from_numpy(pts).to(dev)[None]
    valid = torch.ones_like(alpha, dtype=torch.bool)
    angles, count, _ = _discover_vs_twin(alpha, valid, 128, tol)
    assert int(count[0]) > 97
    table = torch.full((1, 128), float("inf"), device=dev)
    table[0, :97] = torch.from_numpy(centres).to(dev)
    ring = _assign_vs_twin(alpha, valid, table, tol)
    assert int((ring < 97).sum()) > 0 and int((ring == 128).sum()) > 0
    _assign_vs_twin(alpha, valid, angles, tol)


def test_assign_nan_and_empty_tables(dev):
    alpha, valid = _scan_alpha(dev)
    alpha = alpha.clone()
    alpha[::97] = float("nan")
    a, v = alpha[None], valid[None]
    angles, _, _ = _discover_vs_twin(a, v, 64)
    part = torch.sort(torch.cat([angles[0, :5], torch.full(
        (59,), float("nan"), device=dev)])).values[None]
    _assign_vs_twin(a, v, part)
    ring = _assign_vs_twin(a, v, torch.full((1, 64), float("nan"),
                                            device=dev))
    assert bool((ring == 64).all())
    ring = _assign_vs_twin(a, v, torch.full((1, 64), float("inf"),
                                            device=dev))
    assert bool((ring == 64).all())


def test_assign_128_rings_b128(dev):
    # K3 at 128 rings over a batch: the merged multi-LiDAR rig's tables.
    cfg = FilterConfig()
    rows = _merged_rows(dev, (70,))
    x, y, z, _ = geometry.xyz_of(rows, "rows", batched=True)
    valid = geometry.roi_mask_xyz(x, y, z, cfg)
    _, alpha = geometry.vertical_angles(x, y, z)
    angles, count, _ = _discover_vs_twin(alpha, valid, 128)
    assert int(count[0]) > 64
    k = torch.arange(128, device=dev)
    ab = torch.stack([torch.roll(alpha[0], int(s)) for s in 4099 * k])
    vb = torch.stack([torch.roll(valid[0], int(s)) for s in 4099 * k])
    ring = _assign_vs_twin(ab, vb, angles.expand(128, 128).contiguous())
    assert int(ring[vb].max()) >= 64


# K11 over a batch: one launch per 128 lanes, each lane's table and slots
# separate tensors, ids/valid/ok (B, N).

def _gather_lanes(dev, b, n, rings=64, cap=1024, seed=0):
    """(tables, ids, pos, valid, ok) of b lanes of n points: labels in
    {0, 1, 2}, ids and slots partly outside the table (negative ones
    too), the gate off on every third lane."""
    rng = np.random.default_rng(seed)
    tables = [torch.from_numpy(rng.integers(0, 3, (rings, cap)).astype(
        np.int32)).to(dev) for _ in range(b)]
    ids = torch.from_numpy(rng.integers(-3, rings + 3, (b, n)).astype(
        np.int32)).to(dev)
    pos = [torch.from_numpy(rng.integers(-3, cap + 3, n).astype(
        np.int32)).to(dev) for _ in range(b)]
    valid = torch.from_numpy(rng.random((b, n)) < 0.7).to(dev)
    ok = torch.from_numpy(np.arange(b) % 3 != 2).to(dev)
    return tables, ids, pos, valid, ok


@pytest.mark.parametrize("b", [1, 3, 128, 129, 257])
@pytest.mark.parametrize("n", [4099, 16384])
def test_gather_pack_batch_kernel(dev, b, n):
    tables, ids, pos, valid, ok = _gather_lanes(dev, b, n, seed=b)
    before = _build.launch_counts()["gather_pack"]
    got = gather_pack_batch(tables, ids, pos, valid, ok, 10)
    assert _build.launch_counts()["gather_pack"] == before + -(-b // 128)
    _assert_same(got, gather_pack_batch_plain(tables, ids, pos, valid, ok,
                                              10))
    assert all(t.shape == (b, n) for t in got)
    # probably_road_ring equal to the ring count flags no point.
    got = gather_pack_batch(tables, ids, pos, valid, ok, 64)
    _assert_same(got, gather_pack_batch_plain(tables, ids, pos, valid, ok,
                                              64))
    assert not bool(got[2].any())


def test_gather_pack_batch_lane_heads(dev):
    # n odd: lane b's streams start b * n points into their buffers, off a
    # 4-point boundary for b > 0.  Slot vectors cut from one buffer the
    # same way share that offset, so the lane runs its vector loop after a
    # head of 1-3 points; slot vectors of their own do not, so it goes
    # point by point.
    n = 4101
    tables, ids, pos, valid, ok = _gather_lanes(dev, 4, n)
    flat = torch.cat(pos)
    for lanes_pos in (pos, [flat[k * n:(k + 1) * n] for k in range(4)]):
        got = gather_pack_batch(tables, ids, lanes_pos, valid, ok, 10)
        _assert_same(got, gather_pack_batch_plain(tables, ids, lanes_pos,
                                                  valid, ok, 10))


# K1: one device op per call, whatever the batch, layout and stride.

def _k1_points(b, n, seed=0):
    """(b, n, 4) float32 rows around the ROI: about half inside, points on
    its bounds, points whose x + y + z is 0, and an all-invalid last scan
    when b > 1."""
    rng = np.random.default_rng(seed)
    pts = np.empty((b, n, 4), np.float32)
    pts[..., 0] = rng.uniform(-5.0, 35.0, (b, n))
    pts[..., 1] = rng.uniform(-12.0, 12.0, (b, n))
    pts[..., 2] = rng.uniform(-3.5, -0.5, (b, n))
    pts[..., 3] = rng.uniform(0.0, 100.0, (b, n))
    pts[:, ::7, :3] = (1.0, 2.0, -3.0)  # in every bound; x + y + z == 0
    pts[:, 1::11, :3] = (30.0, -10.0, -1.0)  # on the bounds
    if b > 1:
        pts[-1, :, 2] = 5.0
    return pts


def _k1_vs_twin(x, y, z, cfg=FilterConfig()):
    before = _build.launch_counts()["ingest_prep"]
    got = ingest.ingest_prep(x, y, z, cfg)
    assert _build.launch_counts()["ingest_prep"] == before + 1
    _assert_same(got, ingest.ingest_prep_plain(x, y, z, cfg))
    lean = ingest.ingest_prep(x, y, z, cfg, want_star_keys=False)
    _assert_same(lean[::3], ingest.ingest_prep_plain(
        x, y, z, cfg, want_star_keys=False)[::3])
    return got


# Rows of 4 floats (a float4 per point in calls of 8 points a thread),
# rows of 3 and rows at a storage offset of 1-3 floats (point by point),
# planes (a float4 per plane in calls of 8 points a thread); the strided
# layouts up to B = 3 at 131072 points.
K1_CASES = [(b, n, layout) for b in (1, 3, 128) for n in (1, 3, 4097, 131072)
            for layout in ("rows", "rows3", "offset1", "offset2", "offset3",
                           "planar")
            if b * n <= 3 * 131072 or layout in ("rows", "planar")]


@pytest.mark.parametrize("b,n,layout", K1_CASES)
def test_ingest_prep_layouts(dev, b, n, layout):
    pts = torch.from_numpy(_k1_points(b, n, seed=b + n)).to(dev)
    if layout == "planar":
        xyz = pts[..., :3].permute(2, 0, 1).contiguous()
        x, y, z = xyz[0], xyz[1], xyz[2]
    elif layout == "rows3":
        rows = pts[..., :3].contiguous()
        x, y, z = rows[..., 0], rows[..., 1], rows[..., 2]
    elif layout.startswith("offset"):
        off = int(layout[-1])
        flat = torch.zeros(off + pts.numel(), device=dev)
        flat[off:] = pts.flatten()
        rows = flat[off:].view(b, n, 4)
        x, y, z = rows[..., 0], rows[..., 1], rows[..., 2]
    else:
        x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    valid, _, _, piece = _k1_vs_twin(x, y, z)
    if b > 1:
        assert int(piece[-1]) == 0 and not bool(valid[-1].any())


def test_ingest_prep_tickets_across_grids(dev):
    """200 launches alternating B = 1, B = 128 and the SP call's shape
    (one 262144-point scan): each launch's first block zeroes the counts
    the others add to, so piece is exact on every call."""
    cfg = FilterConfig()
    shapes = [(1, 131072), (128, 131072), (1, 262144)]
    inputs = []
    for k, (b, n) in enumerate(shapes):
        pts = torch.from_numpy(_k1_points(b, n, seed=k)).to(dev)
        want = ingest.ingest_prep_plain(pts[..., 0], pts[..., 1],
                                        pts[..., 2], cfg)[3]
        inputs.append((pts, want))
    for call in range(200):
        pts, want = inputs[call % 3]
        piece = ingest.ingest_prep(pts[..., 0], pts[..., 1], pts[..., 2],
                                   cfg)[3]
        assert torch.equal(piece, want), call


def test_ingest_prep_is_one_device_op(dev):
    cfg = FilterConfig()
    for b, n in ((1, 131072), (128, 131072), (1, 262144)):
        pts = torch.from_numpy(_k1_points(b, n)).to(dev)
        planar = pts[..., :3].permute(2, 0, 1).contiguous()
        for x, y, z in ((pts[..., 0], pts[..., 1], pts[..., 2]),
                        tuple(planar)):
            ops = _build.device_ops(lambda: ingest.ingest_prep(x, y, z, cfg))
            assert ops == 1, (b, n, ops)
            torch.cuda.synchronize()
            piece = ingest.ingest_prep(x, y, z, cfg)[3]
            want = ingest.ingest_prep_plain(x, y, z, cfg)[3]
            assert torch.equal(piece, want), (b, n)


def test_gather_pack_batch_is_one_device_op_per_128_lanes(dev):
    for b in (1, 128, 129):
        args = _gather_lanes(dev, b, 4097)
        ops = _build.device_ops(lambda: gather_pack_batch(*args, 10))
        assert ops == -(-b // 128), (b, ops)


def test_ticketed_kernel_refuses_a_second_busy_stream(dev):
    cfg = FilterConfig()
    pts = torch.from_numpy(_k1_points(1, 4097)).to(dev)
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    ingest.ingest_prep(x, y, z, cfg)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        torch.cuda._sleep(200_000_000)  # keeps the side stream busy
        ingest.ingest_prep(x, y, z, cfg)
    with pytest.raises(RuntimeError, match="two streams at once"):
        ingest.ingest_prep(x, y, z, cfg)
    side.synchronize()
    piece = ingest.ingest_prep(x, y, z, cfg)[3]
    assert torch.equal(piece, ingest.ingest_prep_plain(x, y, z, cfg)[3])


def _first_layout(dev, r, p, seed=0):
    """A ring layout for K13: azimuth-ordered rows with NaN, negative and
    past-360 azimuths, ties, -0.0, ragged counts (some past p, some
    negative) and labels of all three kinds."""
    rng = np.random.default_rng(seed)
    alpha = np.sort(rng.uniform(-2.0, 362.0, (r, p)).astype(np.float32), 1)
    pick = rng.random((r, p))
    alpha[pick < 0.03] = np.nan
    alpha[(pick >= 0.03) & (pick < 0.05)] = np.float32(10.5)
    alpha[(pick >= 0.05) & (pick < 0.06)] = np.float32(-0.0)
    label = rng.choice(np.array([0, 1, 1, 1, 2], np.int32), (r, p))
    counts = rng.integers(-1, p + 3, r).astype(np.int32)
    counts[:2] = p
    zero = torch.zeros((r, p), dtype=torch.float32, device=dev)
    return geometry.RingLayout(
        zero, zero, zero, zero, torch.from_numpy(alpha).to(dev),
        torch.from_numpy(label).to(dev),
        torch.full((r, p), -1, dtype=torch.int32, device=dev),
        torch.from_numpy(counts).to(dev),
        torch.zeros((), dtype=torch.int32, device=dev))


@pytest.mark.parametrize("r,p,nr", [(64, 4096, 64), (128, 2048, 128),
                                    (8, 2049, 8), (7, 4097, 7), (8, 4097, 3),
                                    (3, 1, 3), (4000, 64, 4000), (16, 512, 0)])
def test_marker_first_nonroad_kernel(dev, r, p, nr):
    """K13 bit-equal to its twin and one device op a call: the OS1-64 and
    merged shapes, rows one slot past one and two passes of 2048 slots (the
    rows then start off a 16-byte boundary; an odd row count), 2000 blocks
    taking tickets, num_rings below the rows and 0."""
    lay = _first_layout(dev, r, p, seed=r + p)
    num_rings = torch.tensor(nr, dtype=torch.int32, device=dev)
    got = mk.marker_first_nonroad(lay, num_rings)
    _assert_same((got,), (mk.first_nonroad_keys(lay, num_rings),))
    if nr == 0:
        assert bool((got == mk.NO_KEY).all())
    elif p >= 64:
        assert bool((got != mk.NO_KEY).any())
    ops = _build.device_ops(lambda: mk.marker_first_nonroad(lay, num_rings))
    assert ops == 1, ops


def test_marker_first_nonroad_all_road_and_empty(dev):
    lay = _first_layout(dev, 64, 4096, seed=3)
    num_rings = torch.tensor(64, dtype=torch.int32, device=dev)
    for case in (lay._replace(label=torch.ones_like(lay.label)),
                 lay._replace(counts=torch.zeros_like(lay.counts)),
                 lay._replace(alpha=torch.full_like(lay.alpha, float("nan")))):
        got = mk.marker_first_nonroad(case, num_rings)
        _assert_same((got,), (mk.first_nonroad_keys(case, num_rings),))
        assert bool((got == mk.NO_KEY).all())


def test_marker_first_nonroad_refuses_a_second_busy_stream(dev):
    lay = _first_layout(dev, 64, 4096, seed=4)
    num_rings = torch.tensor(64, dtype=torch.int32, device=dev)
    mk.marker_first_nonroad(lay, num_rings)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        torch.cuda._sleep(200_000_000)  # keeps the side stream busy
        mk.marker_first_nonroad(lay, num_rings)
    with pytest.raises(RuntimeError, match="two streams at once"):
        mk.marker_first_nonroad(lay, num_rings)
    side.synchronize()
    _assert_same((mk.marker_first_nonroad(lay, num_rings),),
                 (mk.first_nonroad_keys(lay, num_rings),))
