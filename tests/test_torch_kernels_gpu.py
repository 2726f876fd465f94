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
blocks, its first-block tickets), one device op a call; the curb stencils
(K7) in place at 64 x 4096, 64 x 2048 and 128 x 2048 with star labels on
the table and its SP entry on one SP run's stacked wedges (8 x 128 x
384), at window sizes 3 to 30, one device op and idempotent, the
returning form leaving its input as it was; the compiled SP run on the
card and over a one-rank NCCL group in this process (a FileStore): each
replay bit-equal to run.eager, one capture per key and none under each
of the 15 dynamic swaps, the census of eager after each replay, no
synchronising call, a gloo group's run op by op, a failed capture
raising with no fallback; the batch's lane axis: K4, K5, K6, K8, K9 and
K10 over a batch whose lanes differ (an empty lane, a gated lane, a lane
of curbs only, other ring counts; chip_smoke.py's phase-2 calls) against
their twins and lane-by-lane launches, K9's tickets under batched and
single-lane launches in turns and a graph replay, one launch of each
kernel per batch and process_batch_jit against process_scan_jit lane by
lane; the traced variants that packed_scan_jit, process_batch_jit and the
SP run capture while a profiler records: as many kernel, memcpy and memset
nodes as the plain graph, which stays as it was, outputs bit-equal to its
replays, no count in CAPTURE_COUNTS, every stage timed and the stages
within the replay; the batch entry's lane groups (a batch from pinned host
memory): 128 OS1-64 scans bit-equal to the same batch from device memory,
calls back to back with the copy stream held back, a hot swap without
re-capture, and LANE_GROUP_COPIES moved only by pinned batches of two
groups or more; the ring geometry after K6 (csrc/ring_geometry.cu)
bit-equal to its plain twin, the glue it replaced, on every plane (NaNs
included) and the ring maxima in each form its callers use, on the CPU
tests' cases, 61-slot rows and OS1-64 / OS1-128 drive scans; eager scans
and batches fewer device ops by the glue's, less the kernel's one;
process_scan_jit, the pinned process_batch_jit and the compiled SP run
bit-equal to the same entries under the glue, with one launch a scan
replay, one a lane group (4 a batch of 128) and two an SP scan.  Run on a
machine with the
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

from ring_geometry_cases import CASES as RING_CASES
from ring_geometry_cases import (glue_of_record, placed, ring_geometry_case,
                                 star_labels_of_record)
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
from urban_road_filter_torch.ops.stencil_kernels import (
    fused_xz_zero, fused_xz_zero_, fused_xz_zero_halo, xz_zero_halo_plain,
    xz_zero_plain)
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
    layout, _, _ = geometry.tensorize(x, y, z, ring_id, cap, rings=RINGS)
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
    layout, _, _ = geometry.tensorize(x, y, z, ring_id, CAP, rings=RINGS)
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
    layout, _, _ = geometry.tensorize(*fields, 512)
    got = fused_xz_zero(layout, cfg).label
    _assert_same((got,), (z_zero(x_zero(layout, cfg), cfg).label,))
    assert int(got[1:].max()) == 0


@pytest.fixture(scope="module")
def stencil_layouts(dev):
    """{shape: placed layout} at phase 2's three shapes: an OS1-64 drive
    scan (64 x 4096), a bench lane (64 x 2048) and a merged multi-LiDAR
    scan (128 x 2048), with star labels on 3 % of the slots."""
    smoke = _smoke()
    cfg = FilterConfig()
    rng = np.random.default_rng(7)
    out = {}
    for name, scan, n, rings, cap in (
            ("64x4096", smoke.os1_64_scan(), 131072, 64, 4096),
            ("64x2048", smoke.bench_scans(1)[0], 131072, 64, 2048),
            ("128x2048", smoke.multi_lidar_scans()[0], 262144, 128, 2048)):
        pts = torch.from_numpy(pad_scan(scan, n)).to(dev)
        x, y, z, _ = geometry.xyz_of(pts, "rows")
        x, y, z = x.contiguous(), y.contiguous(), z.contiguous()
        valid = geometry.roi_mask_xyz(x, y, z, cfg)
        _, alpha = geometry.vertical_angles(x, y, z)
        angles, num_rings = geometry.discover_rings(alpha, valid,
                                                    cfg.interval, rings=rings)
        ring_id = geometry.assign_rings(alpha, valid, angles, cfg.interval)
        layout, _, _ = geometry.tensorize(x, y, z, ring_id, cap, rings=rings)
        star = np.where(rng.random((rings, cap)) < 0.03, 2, 0)
        out[name] = layout._replace(label=torch.from_numpy(
            star.astype(np.int32)).to(dev))
    return out


@pytest.mark.parametrize("cp", [3, 5, 10, 30])
@pytest.mark.parametrize("shape", ["64x4096", "64x2048", "128x2048"])
def test_xz_zero_in_place_full_size(dev, stencil_layouts, shape, cp):
    """K7 in place at phase 2's shapes: one launch and one device op a
    call, bit-equal to its twin, idempotent; the returning form leaves its
    input's label as it was."""
    cfg = FilterConfig(curb_points=cp)
    layout = stencil_layouts[shape]
    star = layout.label.clone()
    want = xz_zero_plain(layout, cfg).label
    table = layout.label.clone()
    lay = layout._replace(label=table)
    before = _build.launch_counts()["xz_zero"]
    fused_xz_zero_(lay, cfg)
    assert _build.launch_counts()["xz_zero"] == before + 1
    _assert_same((table,), (want,))
    assert _build.device_ops(lambda: fused_xz_zero_(lay, cfg)) == 1
    _assert_same((table,), (want,))
    _assert_same((fused_xz_zero(layout, cfg).label,), (want,))
    _assert_same((layout.label,), (star,))
    assert int(((want == 2) & (star != 2)).sum()) > 0


@pytest.fixture(scope="module")
def sp_halo_inputs(dev):
    """K7's SP inputs from one SP run of phase 5's OS1-128 scan (8 wedges of
    128 x 384 slots): (layout before the stencils, left, right, prefix,
    total)."""
    from urban_road_filter_torch.parallel.azimuth_parallel import (
        make_azimuth_pipeline)

    _, dims, scan, _ = _smoke().sp_deployments()[0]
    probe = {}
    make_azimuth_pipeline(8, FilterConfig(), dims)(
        torch.from_numpy(pad_scan(scan, dims.max_points)).to(dev),
        probe=probe)
    return probe["halo"], dims.rings


@pytest.mark.parametrize("cp", [3, 5, 10, 30])
def test_xz_zero_halo_kernel(dev, sp_halo_inputs, cp):
    """K7's SP entry at the phase-5 stacked shape, the halo rebuilt for
    each window size: one launch and one device op, bit-equal to its
    plain twin, idempotent."""
    from urban_road_filter_torch.parallel.azimuth_parallel import (
        LocalWedges, _halo)

    (lay, left, right, prefix, total), rings = sp_halo_inputs
    cfg = FilterConfig(curb_points=cp)
    if cp != left["x"].shape[-1]:
        left, right = _halo(LocalWedges(8), lay, rings, cp)
    want = xz_zero_halo_plain(lay, left, right, prefix, total, cfg)
    table = lay.label.clone()
    got = lay._replace(label=table)
    before = _build.launch_counts()["xz_zero"]
    fused_xz_zero_halo(got, left, right, prefix, total, cfg)
    assert _build.launch_counts()["xz_zero"] == before + 1
    _assert_same((table,), (want,))
    assert _build.device_ops(lambda: fused_xz_zero_halo(
        got, left, right, prefix, total, cfg)) == 1
    _assert_same((table,), (want,))
    assert int(((want == 2) & (lay.label != 2)).sum()) > 0


def _stenciled(dev, scene, cfg):
    x, y, z, _, ring_id, num_rings = _rings(dev, scene, cfg=cfg)
    layout, _, _ = geometry.tensorize(x, y, z, ring_id, CAP, rings=RINGS)
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
    layout, pos, _ = geometry.tensorize(x, y, z, ring_id, CAP, rings=RINGS)
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
    layout, pos, _ = geometry.tensorize(x, y, z, ring_id, CAP, rings=RINGS)
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
        layout, _, _ = geometry.tensorize(x, y, z, ring_id, cap, rings=rings)
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
    layout, _, _ = geometry.tensorize(x, y, z, ring_id, CAP, rings=RINGS)
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
    on every field, eager and replayed; K8 and K14 launch once per pass
    over all wedges, K12 once per wedge, K7 once over all wedges, in the
    eager run and in each replay."""
    from urban_road_filter_torch.parallel.azimuth_parallel import (
        azimuth_sorted, make_azimuth_pipeline)

    dims = PipelineDims(max_points=8192, rings=RINGS, ring_capacity=CAP)
    scan = azimuth_sorted(make_scan(SCENES["two_curbs"](), n_rings=16,
                                    n_azimuth=384, seed=11))
    pts = torch.from_numpy(pad_scan(scan, dims.max_points)).to(dev)
    run = make_azimuth_pipeline(8, cfg, dims)
    want = process_scan(pts, cfg, dims)
    run(pts)  # the capture, after one eager run
    for call in (run.eager, run):
        _build.reset_launch_counts()
        got = call(pts)
        counts = _build.launch_counts()
        assert counts["flood_road"] == 8 and counts["marker_state"] == 2
        assert counts["flood_blocked"] == 1 and counts["xz_zero"] == 1
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


# ---- the dynamic parameters read from device memory ----
# K1-K4, K7 (both entries), K8, K9 and K12 read their thresholds from the
# configuration's parameter buffer (config.bind_params): each is held
# against its plain twin given the same values as host floats, the form
# the kernels took them in before (by value), while one buffer is
# rewritten between launches as a compiled entry point's hot swap does.

SWAPPED = dict(interval=0.3, curb_height=0.11, beam_zone=42.5, min_x=1.0,
               max_x=25.0, min_y=-8.0, max_y=8.0, min_z=-2.8, max_z=-1.2,
               cylinder_deg_x=140.0, cylinder_deg_z=130.0,
               curb_slope_deg=45.0, kdev_param=1.5, kdist_param=3.0,
               dmin_param=8)


class _Buffer:
    """One parameter buffer on the card; ``bound(cfg)`` writes cfg's
    dynamic values into it (one device copy) and returns the config bound
    to it."""

    def __init__(self, dev):
        from urban_road_filter_torch import config as C

        self.C = C
        self.params = torch.empty(len(C.DynConfig._fields),
                                  dtype=torch.float32, device=dev)

    def bound(self, cfg):
        st, dyn = cfg.split()
        self.params.copy_(self.C.param_buffer(dyn, self.params.device))
        rc = self.C.bind_params(st, self.params)
        assert rc.beam_zone.data_ptr() == self.params.data_ptr() + 4 * (
            self.C.DYN_INDEX["beam_zone"])
        return rc

    def slot(self, name, value):
        """The 0-d view of one slot, set to value (float32)."""
        i = self.C.DYN_INDEX[name]
        self.params[i] = float(np.float32(value))
        return self.params[i]


def _ulps(v):
    v = np.float32(v)
    return [float(np.nextafter(v, np.float32(-np.inf))), float(v),
            float(np.nextafter(v, np.float32(np.inf)))]


def test_ingest_prep_reads_roi_from_buffer(dev):
    """K1 with its box from the buffer, bounds on a point's coordinates and
    one ulp either side, then the swapped box."""
    rows = _batch_rows(dev, 4096, 16, (1, 2))
    x, y, z, _ = geometry.xyz_of(rows, "rows", batched=True)
    buf = _Buffer(dev)
    valid = ingest.ingest_prep_plain(x, y, z, FilterConfig())[0]
    k = int(torch.nonzero(valid[0])[len(torch.nonzero(valid[0])) // 2])
    px, py, pz = (float(t[0, k]) for t in (x, y, z))
    cfgs = [FilterConfig(**SWAPPED), FilterConfig()]
    for name, v in (("min_x", px), ("max_x", px), ("min_y", py),
                    ("max_y", py), ("min_z", pz), ("max_z", pz)):
        cfgs += [FilterConfig(**{name: e}) for e in _ulps(v)]
    for cfg in cfgs:
        got = ingest.ingest_prep(x, y, z, buf.bound(cfg))
        _assert_same(got, ingest.ingest_prep_plain(x, y, z, cfg))


def test_ring_kernels_read_interval_from_buffer(dev):
    """K2 and K3 with the interval from a buffer slot: a ring's points
    exactly interval away and one ulp either side, at three intervals."""
    centres = np.linspace(-20.0, 20.0, 97).astype(np.float32)
    buf = _Buffer(dev)
    for tol in (0.18, 0.3, 0.5):
        t32 = np.float32(tol)
        edges = np.concatenate([centres + t32, centres - t32])
        stream = np.resize(np.concatenate(
            [centres, edges, np.nextafter(edges, np.float32(np.inf)),
             np.nextafter(edges, np.float32(-np.inf))]).astype(np.float32),
            8192)
        alpha = torch.from_numpy(stream).to(dev)[None]
        valid = torch.ones_like(alpha, dtype=torch.bool)
        for e in _ulps(tol):
            iv = buf.slot("interval", e)
            angles, count = ingest.discover_rings(alpha, valid, iv, 128)
            _assert_same((angles, count), ingest.discover_rings_plain(
                alpha, valid, e, 128))
            _assert_same((ingest.assign_rings(alpha, valid, angles, iv),),
                         (ingest.assign_rings_plain(alpha, valid, angles,
                                                    e),))


@pytest.mark.parametrize("kw", [dict(), SWAPPED,
                                dict(kdev_param=0.6, dmin_param=3),
                                dict(curb_slope_deg=10.0, dmin_param=30)])
def test_star_search_reads_walk_params_from_buffer(dev, kw):
    """K4 with slope_param, kdev, kdist and dmin from the buffer."""
    fk, r_key, z = _star_keys(dev)
    cfg = FilterConfig(**kw)
    hp = star.star_search(fk, r_key, z, _Buffer(dev).bound(cfg))
    _assert_same((hp,), (star.star_search_plain(fk, r_key, z, cfg),))


@pytest.mark.parametrize("kw", [SWAPPED, dict(curb_height=0.01),
                                dict(cylinder_deg_x=170.0,
                                     cylinder_deg_z=100.0)])
def test_xz_zero_reads_thresholds_from_buffer(dev, stencil_layouts,
                                              sp_halo_inputs, kw):
    """K7 and its SP entry with cos_x, cos_z and curb_height from the
    buffer."""
    cfg = FilterConfig(**kw)
    buf = _Buffer(dev)
    for lay in stencil_layouts.values():
        _assert_same((fused_xz_zero(lay, buf.bound(cfg)).label,),
                     (xz_zero_plain(lay, cfg).label,))
    (lay, left, right, prefix, total), _ = sp_halo_inputs
    table = lay.label.clone()
    fused_xz_zero_halo(lay._replace(label=table), left, right, prefix, total,
                       buf.bound(cfg))
    _assert_same((table,), (xz_zero_halo_plain(lay, left, right, prefix,
                                               total, cfg),))


@pytest.mark.parametrize("bz", [30.0, 45.5, 10.0, 42.5, 100.0])
def test_flood_kernels_read_beam_zone_from_buffer(dev, flood_layouts, bz):
    """K8, K9 and K12 with the beam zone from a buffer slot, at the zone
    and one ulp either side (the special starts exist only at integer
    zones), on flood_cases' layouts, widths and reach bits."""
    buf = _Buffer(dev)
    for shape, cases in flood_layouts.items():
        for name, lay, rf, rb, w, _, nr in cases[::4]:
            for e in _ulps(bz):
                v = buf.slot("beam_zone", e)
                _assert_same(bs.flood_blocked(lay, w, v),
                             bs.flood_blocked_plain(lay, w, e))
                _assert_same(bs.flood_labeled(lay, rf, rb, w, v, nr),
                             bs.flood_labeled_plain(lay, rf, rb, w, e, nr))
                _assert_same((bs.flood_road(lay, rf, rb, w, v),),
                             (bs.flood_road_plain(lay, rf, rb, w, e),))
                _assert_same((bs.window_widths(lay.d2[:, 0], v),),
                             (bs.window_widths(lay.d2[:, 0], e),))


def test_replay_and_eager_launch_refuse_each_other(dev):
    """K1, K9 and K13 take tickets from per-device counters: a
    packed_scan_jit replay left running on stream A and an eager
    ingest_prep on stream B refuse each other in either order, and both
    run once the other stream is synchronised."""
    from urban_road_filter_torch import packed_scan, packed_scan_jit

    dims = PipelineDims(max_points=N, rings=RINGS, ring_capacity=CAP)
    pts = torch.from_numpy(pad_scan(make_scan(
        SCENES["two_curbs"](), n_rings=24, n_azimuth=384, seed=3), N)).to(dev)
    x, y, z, _ = geometry.xyz_of(pts, "rows")
    cfg = FilterConfig()
    want = packed_scan(pts, cfg, dims)
    packed_scan_jit(pts, cfg, dims)  # the capture
    torch.cuda.synchronize()
    a, b = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    with torch.cuda.stream(a):
        torch.cuda._sleep(200_000_000)
        got = packed_scan_jit(pts, cfg, dims)
    with torch.cuda.stream(b), pytest.raises(RuntimeError,
                                             match="two streams at once"):
        ingest.ingest_prep(x[None], y[None], z[None], cfg)
    a.synchronize()
    _assert_same(got, want)
    with torch.cuda.stream(b):
        torch.cuda._sleep(200_000_000)
        ingest.ingest_prep(x[None], y[None], z[None], cfg)
    with torch.cuda.stream(a), pytest.raises(RuntimeError,
                                             match="two streams at once"):
        packed_scan_jit(pts, cfg, dims)
    b.synchronize()
    with torch.cuda.stream(a):
        got = packed_scan_jit(pts, cfg, dims)
    a.synchronize()
    _assert_same(got, want)


# --- the compiled SP run (make_azimuth_pipeline on one card) ---

def _sp_scan(dev, dims, seed=11):
    from urban_road_filter_torch.parallel.azimuth_parallel import (
        azimuth_sorted)

    scan = azimuth_sorted(make_scan(SCENES["two_curbs"](), n_rings=16,
                                    n_azimuth=384, seed=seed))
    return torch.from_numpy(pad_scan(scan, dims.max_points)).to(dev)


@pytest.mark.parametrize("layout", ["rows", "planar"])
@pytest.mark.parametrize("star_on", [True, False])
def test_sp_replay_equals_eager(dev, star_on, layout):
    """One capture per key; each replay bit-equal to run.eager on every
    field, the graph's launches credited per replay."""
    from urban_road_filter_torch import pipeline as pl
    from urban_road_filter_torch.parallel.azimuth_parallel import (
        make_azimuth_pipeline)

    dims = PipelineDims(max_points=8192, rings=RINGS, ring_capacity=CAP)
    cfg = FilterConfig(star_shaped_method=star_on)
    pts = _sp_scan(dev, dims)
    if layout == "planar":
        pts = pts[:, :3].T.contiguous()
    run = make_azimuth_pipeline(8, cfg, dims)
    before = pl.CAPTURE_COUNTS["sp"]
    first = run(pts, layout=layout)
    assert pl.CAPTURE_COUNTS["sp"] == before + 1
    want = run.eager(pts, layout=layout)
    _assert_same(first, want)
    _build.reset_launch_counts()
    for _ in range(3):
        _assert_same(run(pts, layout=layout), want)
    counts = _build.launch_counts()
    assert counts["flood_road"] == 24 and counts["marker_state"] == 6
    assert counts["star_walk"] == (24 if star_on else 0)
    assert pl.CAPTURE_COUNTS["sp"] == before + 1
    (entry,) = run.entries.values()
    assert entry.stats["nodes"]["kernel"] > 0 and entry.graph is not None


def test_sp_hot_swap_without_recapture(dev):
    """Each dynamic field swapped, and all at once: the replay equals
    run.eager under the new configuration, no capture; max_x=12 changes
    the labels; a static swap captures once."""
    from urban_road_filter_torch import pipeline as pl
    from urban_road_filter_torch.parallel.azimuth_parallel import (
        make_azimuth_pipeline)

    dims = PipelineDims(max_points=8192, rings=RINGS, ring_capacity=CAP)
    pts = _sp_scan(dev, dims)
    run = make_azimuth_pipeline(8, FilterConfig(), dims)
    base = run(pts)
    before = dict(pl.CAPTURE_COUNTS)
    for name, val in [*SWAPPED.items(), ("all", None)]:
        cfg = (FilterConfig(**SWAPPED) if name == "all"
               else FilterConfig(**{name: val}))
        _assert_same(run(pts, cfg), run.eager(pts, cfg))
    assert pl.CAPTURE_COUNTS == before
    assert not torch.equal(run(pts, FilterConfig(max_x=12.0)).labels,
                           base.labels)
    _assert_same(run(pts), base)
    run(pts, FilterConfig(blind_spots=False))
    assert pl.CAPTURE_COUNTS["sp"] == before["sp"] + 1


def test_sp_makes_no_synchronising_call(dev):
    """Eager and compiled SP, and a hot swap, under
    set_sync_debug_mode("error")."""
    from urban_road_filter_torch.parallel.azimuth_parallel import (
        make_azimuth_pipeline)

    dims = PipelineDims(max_points=8192, rings=RINGS, ring_capacity=CAP)
    pts = _sp_scan(dev, dims)
    run = make_azimuth_pipeline(8, FilterConfig(), dims)
    calls = [lambda: run.eager(pts), lambda: run(pts),
             lambda: run(pts, FilterConfig(beam_zone=42.5))]
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    for fn in calls:
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_sp_failed_capture_raises(dev, monkeypatch):
    """A host read inside the SP stages fails the capture, which raises;
    nothing falls back to the eager stages."""
    from urban_road_filter_torch import pipeline as pl
    from urban_road_filter_torch.parallel import azimuth_parallel as ap

    dims = PipelineDims(max_points=8192, rings=RINGS, ring_capacity=CAP)
    pts = _sp_scan(dev, dims)
    quadrants = ap._quadrants

    def reads_back(*args):
        q = quadrants(*args)
        float(q[0])  # a synchronising host read
        return q

    monkeypatch.setattr(ap, "_quadrants", reads_back)
    run = ap.make_azimuth_pipeline(8, FilterConfig(), dims)
    before = dict(pl.CAPTURE_COUNTS)
    with pytest.raises(RuntimeError, match="CUDA-graph capture failed"):
        run(pts)
    assert not run.entries and pl.CAPTURE_COUNTS == before
    torch.cuda.synchronize()


# --- the compiled SP run over an NCCL group (one rank, in this process) ---

@pytest.fixture(scope="module")
def nccl(dev, tmp_path_factory):
    """A one-rank NCCL process group met through a FileStore, destroyed
    after the module's tests."""
    import torch.distributed as dist

    store = dist.FileStore(str(tmp_path_factory.mktemp("nccl") / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


def _census(run):
    return {k: dict(v) for k, v in run.wedges.census.items()}


@pytest.mark.parametrize("layout", ["rows", "planar"])
@pytest.mark.parametrize("star_on", [True, False])
def test_sp_nccl_replay_equals_eager(dev, nccl, star_on, layout):
    """Over the NCCL group ``run`` captures one graph per key, its
    collectives inside; each replay is bit-equal to run.eager, leaves
    eager's census and credits the graph's launches."""
    from urban_road_filter_torch import pipeline as pl
    from urban_road_filter_torch.parallel.azimuth_parallel import (
        make_azimuth_pipeline)

    dims = PipelineDims(max_points=8192, rings=RINGS, ring_capacity=CAP)
    cfg = FilterConfig(star_shaped_method=star_on)
    pts = _sp_scan(dev, dims)
    if layout == "planar":
        pts = pts[:, :3].T.contiguous()
    run = make_azimuth_pipeline(8, cfg, dims, group=nccl)
    assert run is not run.eager
    before = pl.CAPTURE_COUNTS["sp"]
    first = run(pts, layout=layout)
    assert pl.CAPTURE_COUNTS["sp"] == before + 1
    replayed = _census(run)
    want = run.eager(pts, layout=layout)
    eager = _census(run)
    assert eager and replayed == eager
    assert eager["all_gather"]["calls"] == 3
    assert eager["all_reduce"]["calls"] == 11
    _assert_same(first, want)
    _build.reset_launch_counts()
    for _ in range(3):
        run.wedges.census.clear()
        _assert_same(run(pts, layout=layout), want)
        assert _census(run) == eager
    counts = _build.launch_counts()
    assert counts["flood_road"] == 24 and counts["marker_state"] == 6
    assert counts["star_walk"] == (24 if star_on else 0)
    assert pl.CAPTURE_COUNTS["sp"] == before + 1
    (entry,) = run.entries.values()
    nodes = entry.stats["nodes"]
    assert nodes["kernel"] > 0 and entry.graph is not None
    assert sum(nodes.values()) > 400, nodes
    assert entry.stats["pool_bytes"] > 0


def test_sp_nccl_hot_swap_without_recapture(dev, nccl):
    """Each of the 15 dynamic fields swapped, and all at once: the replay
    equals run.eager under the new configuration, no capture; a static
    swap captures once."""
    from urban_road_filter_torch import config as C
    from urban_road_filter_torch import pipeline as pl
    from urban_road_filter_torch.parallel.azimuth_parallel import (
        make_azimuth_pipeline)

    assert len(SWAPPED) == len(C.DynConfig._fields)
    dims = PipelineDims(max_points=8192, rings=RINGS, ring_capacity=CAP)
    pts = _sp_scan(dev, dims)
    run = make_azimuth_pipeline(8, FilterConfig(), dims, group=nccl)
    base = run(pts)
    before = dict(pl.CAPTURE_COUNTS)
    for name, val in [*SWAPPED.items(), ("all", None)]:
        cfg = (FilterConfig(**SWAPPED) if name == "all"
               else FilterConfig(**{name: val}))
        _assert_same(run(pts, cfg), run.eager(pts, cfg))
    assert pl.CAPTURE_COUNTS == before and len(run.entries) == 1
    assert not torch.equal(run(pts, FilterConfig(max_x=12.0)).labels,
                           base.labels)
    _assert_same(run(pts), base)
    run(pts, FilterConfig(blind_spots=False))
    assert pl.CAPTURE_COUNTS["sp"] == before["sp"] + 1


def test_sp_nccl_makes_no_synchronising_call(dev, nccl):
    """Eager and compiled over the NCCL group, and a hot swap, under
    set_sync_debug_mode("error")."""
    from urban_road_filter_torch.parallel.azimuth_parallel import (
        make_azimuth_pipeline)

    dims = PipelineDims(max_points=8192, rings=RINGS, ring_capacity=CAP)
    pts = _sp_scan(dev, dims)
    run = make_azimuth_pipeline(8, FilterConfig(), dims, group=nccl)
    calls = [lambda: run.eager(pts), lambda: run(pts),
             lambda: run(pts, FilterConfig(beam_zone=42.5))]
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    for fn in calls:
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_sp_gloo_group_on_the_card_runs_eager(dev, nccl):
    """A gloo group's run on the card is run.eager (gloo stages each
    collective through the host), with no entries; it equals the one-card
    run."""
    import torch.distributed as dist

    from urban_road_filter_torch.parallel.azimuth_parallel import (
        make_azimuth_pipeline)

    dims = PipelineDims(max_points=8192, rings=RINGS, ring_capacity=CAP)
    pts = _sp_scan(dev, dims)
    gloo = dist.new_group(backend="gloo")
    run = make_azimuth_pipeline(8, FilterConfig(), dims, device=dev,
                                group=gloo)
    assert run is run.eager and run.entries == {}
    _assert_same(run(pts), make_azimuth_pipeline(8, FilterConfig(),
                                                 dims).eager(pts))
    dist.destroy_process_group(gloo)


def test_sp_nccl_failed_capture_raises(dev, nccl, monkeypatch):
    """A host read inside the SP stages fails the capture over a (new)
    NCCL group, which raises; the stages ran twice (the eager run before
    the capture, and the capture), nothing fell back to them."""
    import torch.distributed as dist

    from urban_road_filter_torch import pipeline as pl
    from urban_road_filter_torch.parallel import azimuth_parallel as ap

    dims = PipelineDims(max_points=8192, rings=RINGS, ring_capacity=CAP)
    pts = _sp_scan(dev, dims)
    quadrants, body = ap._quadrants, ap._run
    runs = []

    def reads_back(*args):
        q = quadrants(*args)
        float(q[0])  # a synchronising host read
        return q

    def counted(*args, **kw):
        runs.append(1)
        return body(*args, **kw)

    group = dist.new_group(backend="nccl")
    run = ap.make_azimuth_pipeline(8, FilterConfig(), dims, group=group)
    monkeypatch.setattr(ap, "_quadrants", reads_back)
    monkeypatch.setattr(ap, "_run", counted)
    before = dict(pl.CAPTURE_COUNTS)
    with pytest.raises(RuntimeError, match="CUDA-graph capture failed"):
        run(pts)
    assert len(runs) == 2
    assert not run.entries and pl.CAPTURE_COUNTS == before
    torch.cuda.synchronize()


# ---- the batch path's lane axis: K4-K6, K8-K10 once over a batch ----

LANE_DIMS = PipelineDims(max_points=N, rings=RINGS, ring_capacity=CAP)


def _lane_planes(dev):
    """Five lanes that differ, (3, 5, N) planes: two_curbs (24 rings),
    blind_spot (16 rings, 512 azimuths), a 10-point scan (under the gate),
    an empty scan and curb_gap (8 rings, 1024 azimuths)."""
    scans = [make_scan(SCENES["two_curbs"](), n_rings=24, n_azimuth=384,
                       seed=0),
             make_scan(SCENES["blind_spot"](), n_rings=16, n_azimuth=512,
                       seed=1),
             np.tile(np.float32([[1, 0, -2, 0]]), (10, 1)),
             np.zeros((0, 4), np.float32),
             make_scan(SCENES["curb_gap"](), n_rings=8, n_azimuth=1024,
                       seed=2)]
    return torch.from_numpy(planarize_batch(np.stack(
        [pad_scan(s, N) for s in scans]))).to(dev)


@pytest.mark.parametrize("cfg", [
    FilterConfig(), FilterConfig(star_shaped_method=False),
    FilterConfig(x_direction=1, starbeam_filter=True, beam_zone=45.0)])
def test_batched_kernels_vs_twins_and_lanes(dev, cfg):
    """Each batched kernel (K4, K5, K6, K8 with a window row per lane, K9,
    K10) bit-equal to its plain twin and to the same kernel launched lane
    by lane, on the stage inputs of a batch whose lanes differ, with a
    lane of curbs only for K8-K10 (chip_smoke.py's phase-2 calls), and the
    markers under another ring count per lane."""
    c = _smoke()
    d, bound = c.batch_probe(dev, _lane_planes(dev), cfg, LANE_DIMS)
    calls = c.batch_kernel_calls(d, bound, LANE_DIMS, curbs=True)
    assert set(calls) == set(c.BATCHED_KERNELS) - (
        set() if cfg.star_shaped_method else {"star_walk"})
    for name, (args, call, plain, _, _) in calls.items():
        got = call(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = plain(*args)
        _assert_same(got, want if isinstance(want, tuple) else (want,))
        _assert_same(got, c.lanewise(call, *args))
    if cfg.star_shaped_method:
        hp = calls["star_walk"][1](*calls["star_walk"][0])
        assert hp.shape == (5, 360) and not hp[2:4].any() and hp[0].any()
    road, _, kf = calls["marker_points"][0]
    nr = torch.tensor([5, 1, 0, 0, 3, 64], dtype=torch.int32, device=dev)
    table = mk.marker_points(road, nr, kf)
    _assert_same((table,), (mk.marker_points_plain(road, nr, kf),))
    _assert_same((table,), c.lanewise(mk.marker_points, road, nr, kf))


def test_flood_labeled_batched_tickets(dev):
    """K9's tickets count every block of a batched grid: batched and
    single-lane launches in turns, then a graph of a batched launch
    replayed between eager ones (kf reset before each replay), each
    bit-equal to the twin."""
    c = _smoke()
    d, bound = c.batch_probe(dev, _lane_planes(dev), FilterConfig(),
                             LANE_DIMS)
    args, k9, p9, _, _ = c.batch_kernel_calls(
        d, bound, LANE_DIMS, curbs=False)["flood_labeled"]
    want = p9(*args)
    lane0 = c.first_lane(k9, *args)
    for _ in range(3):
        _assert_same(k9(*args), want)
        _assert_same(lane0(), (want[0][0], want[1][0]))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with _build.recording() as launches, torch.cuda.graph(graph):
        out = k9(*args)
    assert dict(launches) == {"flood_labeled": 1}
    for _ in range(3):
        out[0].fill_(-1)
        out[1].fill_(0)
        _build.replayed(launches, ["flood_labeled"], dev)
        graph.replay()
        _assert_same(out, want)
        _assert_same(lane0(), (want[0][0], want[1][0]))
    torch.cuda.synchronize()


@pytest.mark.parametrize("cfg", [FilterConfig(),
                                 FilterConfig(star_shaped_method=False)])
def test_batch_launches_once_and_jit_equals_lanes(dev, cfg):
    """process_batch launches each kernel of its path once per batch, and
    process_batch_jit equals process_batch and each lane's
    process_scan_jit on every field."""
    from urban_road_filter_torch import (
        process_batch_jit, process_scan_jit)

    planes = _lane_planes(dev)
    _build.reset_launch_counts()
    eager = process_batch(planes, cfg, LANE_DIMS, layout="planar")
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    on_path = [k for k in _build.KERNELS if k not in (
        "flood_road", "marker_first_nonroad", "marker_state")]
    if not cfg.star_shaped_method:
        on_path.remove("star_walk")
    assert {k: counts[k] for k in on_path} == dict.fromkeys(on_path, 1)
    got = process_batch_jit(planes, cfg, LANE_DIMS, layout="planar")
    _assert_same(got, eager)
    for b in range(planes.shape[1]):
        _assert_same([f[b] for f in got], process_scan_jit(
            planes[:, b], cfg, LANE_DIMS, layout="planar"))


# ---- the batch entry's lane groups (a batch from pinned host memory) ----

OS1_64 = PipelineDims(max_points=131072, rings=64, ring_capacity=2048,
                      beam_capacity=512)


@pytest.fixture(scope="module")
def os1_64_batches(dev):
    """Two (128, 131072, 4) batches in pinned host memory: 8 OS1-64 scans
    (4 scenes, 64 rings x 2048 azimuths) on 16 lanes each, in two
    orders."""
    names = ("two_curbs", "blind_spot", "curb_gap", "high_curbs")
    scans = [pad_scan(make_scan(SCENES[names[k % 4]](), n_rings=64,
                                n_azimuth=2048, seed=k), OS1_64.max_points)
             for k in range(8)]
    rng = np.random.default_rng(0)
    return [torch.from_numpy(np.stack([scans[j] for j in rng.permutation(
        np.repeat(np.arange(8), 16))])).pin_memory() for _ in range(2)]


def _lane_group_entry(shape, layout="rows"):
    from urban_road_filter_torch import pipeline as pl

    (entry,) = [e for k, e in pl._compiled.items()
                if type(e) is pl._LaneGroups and k[3] == layout
                and k[4] == tuple(shape)]
    return entry


@pytest.mark.parametrize("layout", ["rows", "planar"])
def test_lane_groups_equal_the_device_batch(dev, os1_64_batches, layout):
    """A pinned batch of 128 OS1-64 scans goes in by lane groups: one new
    entry, one call of ceil(128 / LANE_GROUP) groups in LANE_GROUP_COPIES,
    and every ScanResult field bit-equal to process_batch_jit of the same
    batch handed over from device memory (the whole batch copied in, one
    body over the 128 lanes)."""
    from urban_road_filter_torch import pipeline as pl
    from urban_road_filter_torch import process_batch_jit

    host = os1_64_batches[0]
    if layout == "planar":
        host = torch.from_numpy(planarize_batch(host.numpy())).pin_memory()
    cfg = FilterConfig()
    want = process_batch_jit(host.to(dev), cfg, OS1_64, layout=layout)
    captures = dict(pl.CAPTURE_COUNTS)
    before = dict(pl.LANE_GROUP_COPIES)
    got = process_batch_jit(host, cfg, OS1_64, layout=layout)
    captures["batch"] += 1
    assert pl.CAPTURE_COUNTS == captures
    assert pl.LANE_GROUP_COPIES == {
        "calls": before["calls"] + 1,
        "groups": before["groups"] + -(-128 // pl.LANE_GROUP)}
    entry = _lane_group_entry(host.shape, layout)
    assert entry.groups == pl.lane_groups(128, pl.LANE_GROUP)
    _assert_same(got, want)
    assert got.ok.shape == (128,) and bool(got.ok.all())


def test_lane_groups_back_to_back(dev, os1_64_batches):
    """Pinned batches through the lane-group entry with no synchronisation
    between the calls, the copy stream held back before the second (its
    graph must wait for every group's copy) and the first batch again
    right after it (its copies must wait for the last replay): each
    result bit-equal to its batch's from device memory, none overwritten
    by a later call."""
    from urban_road_filter_torch import process_batch_jit

    cfg = FilterConfig()
    first, second = os1_64_batches
    wants = [process_batch_jit(h.to(dev), cfg, OS1_64)
             for h in (first, second)]
    process_batch_jit(first, cfg, OS1_64)
    entry = _lane_group_entry(first.shape)
    torch.cuda.synchronize()
    a = process_batch_jit(first, cfg, OS1_64)
    with torch.cuda.stream(entry.stream):
        torch.cuda._sleep(100_000_000)  # tens of ms at the card's clocks
    b = process_batch_jit(second, cfg, OS1_64)
    c = process_batch_jit(first, cfg, OS1_64)
    torch.cuda.synchronize()
    _assert_same(a, wants[0])
    _assert_same(b, wants[1])
    _assert_same(c, wants[0])
    assert not torch.equal(a.labels, b.labels)


def test_lane_groups_hot_swap_without_recapture(dev, os1_64_batches):
    """Other dynamic values on the lane-group entry: no new capture
    (CAPTURE_COUNTS unchanged), and the new values take effect, bit-equal
    to the batch's from device memory under them."""
    from urban_road_filter_torch import pipeline as pl
    from urban_road_filter_torch import process_batch_jit

    host = os1_64_batches[1]
    default = process_batch_jit(host, FilterConfig(), OS1_64)
    swapped = FilterConfig(beam_zone=45.5, max_x=12.0)
    before = dict(pl.CAPTURE_COUNTS)
    got = process_batch_jit(host, swapped, OS1_64)
    assert pl.CAPTURE_COUNTS == before
    _assert_same(got, process_batch_jit(host.to(dev), swapped, OS1_64))
    assert int(got.roi.sum()) < int(default.roi.sum())


def test_lane_group_copies_only_for_pinned_batches(dev):
    """LANE_GROUP_COPIES moves only for a batch in pinned host memory of
    at least two lane groups: not for a scan from pinned memory
    (packed_scan_jit, process_scan_jit, the SP run), nor for a batch on
    the card, in pageable memory or one lane short of two groups; then
    2 * LANE_GROUP pinned lanes make one call of two groups, bit-equal
    lane by lane to the device batch's."""
    from urban_road_filter_torch import pipeline as pl
    from urban_road_filter_torch import (
        packed_scan_jit, process_batch_jit, process_scan_jit)
    from urban_road_filter_torch.parallel.azimuth_parallel import (
        make_azimuth_pipeline)

    cfg = FilterConfig()
    b = 2 * pl.LANE_GROUP
    wide = _batch_rows("cpu", N, 16, range(b + 1))
    sp_dims = PipelineDims(max_points=8192, rings=RINGS, ring_capacity=CAP)
    sp_run = make_azimuth_pipeline(8, cfg, sp_dims)
    before = dict(pl.LANE_GROUP_COPIES)
    scan = wide[0].pin_memory()
    packed_scan_jit(scan, cfg, LANE_DIMS)
    process_scan_jit(scan, cfg, LANE_DIMS)
    sp_run(_sp_scan("cpu", sp_dims).pin_memory())
    want = process_batch_jit(wide.to(dev), cfg, LANE_DIMS)
    process_batch_jit(wide, cfg, LANE_DIMS)
    short = process_batch_jit(wide[:b - 1].pin_memory(), cfg, LANE_DIMS)
    torch.cuda.synchronize()
    assert pl.LANE_GROUP_COPIES == before
    got = process_batch_jit(wide[:b].pin_memory(), cfg, LANE_DIMS)
    assert pl.LANE_GROUP_COPIES == {"calls": before["calls"] + 1,
                                    "groups": before["groups"] + 2}
    _assert_same(got, [f[:b] for f in want])
    _assert_same(short, [f[:b - 1] for f in want])


# ---- the traced variants of the compiled entries (a profiler recording) ----

TRACED_STAGES = {
    "packed": ("ingest", "star", "tensorize", "xz_zero", "blind_spots",
               "markers", "gather"),
    "sp": ("sp_partition", "sp_rings", "sp_star", "sp_tensorize",
           "sp_xz_zero", "sp_blind_spots", "sp_markers", "sp_gather")}
TRACED_STAGES["batch"] = TRACED_STAGES["packed"]


def _entry_calls(dev, kind, group=None):
    """(call(seed) -> outputs, the entry's cache, its input shape) of a
    compiled entry of ``kind`` on the card, at a small size (the SP run
    over ``group`` where one is given; "batch-pinned": the batch entry of
    two lane groups from pinned host memory)."""
    from urban_road_filter_torch import packed_scan_jit, process_batch_jit
    from urban_road_filter_torch import pipeline as pl
    from urban_road_filter_torch.parallel.azimuth_parallel import (
        make_azimuth_pipeline)

    cfg = FilterConfig()
    if kind == "sp":
        dims = PipelineDims(max_points=8192, rings=RINGS, ring_capacity=CAP)
        run = make_azimuth_pipeline(8, cfg, dims, group=group)
        return ((lambda seed: run(_sp_scan(dev, dims, seed))), run.entries,
                (8192, 4))
    if kind == "batch":
        return ((lambda seed: process_batch_jit(_batch_rows(
            dev, N, 16, (seed, seed + 1, seed + 2)), cfg, LANE_DIMS)),
            pl._compiled, (3, N, 4))
    if kind == "batch-pinned":
        b = 2 * pl.LANE_GROUP
        return ((lambda seed: process_batch_jit(_batch_rows(
            "cpu", N, 16, range(seed, seed + b)).pin_memory(), cfg,
            LANE_DIMS)), pl._compiled, (b, N, 4))
    return ((lambda seed: packed_scan_jit(
        _batch_rows(dev, N, 16, (seed,))[0], cfg, LANE_DIMS)),
        pl._compiled, (N, 4))


@pytest.mark.parametrize("kind", ["packed", "batch", "batch-pinned", "sp",
                                  "sp-nccl"])
def test_traced_variant_beside_the_plain_graph(dev, kind, request):
    """A profiler recording: the entry captures its traced variant once,
    counted in TRACED_CAPTURES and not in CAPTURE_COUNTS, with as many
    kernel, memcpy and memset nodes as the plain graph, which it leaves
    as it was (the same graph, the same nodes); traced replays are
    bit-equal to plain replays on the same scans and credit the same
    launches; untraced calls replay the plain graph again; every stage is
    timed, and the stages sum to at most the replay.  "sp-nccl": the SP
    run over the one-rank NCCL group, its collectives in both graphs;
    "batch-pinned": the batch entry's lane groups, each stage entered once
    a group and its times summed over them."""
    from torch.profiler import ProfilerActivity, profile

    from urban_road_filter_torch import pipeline as pl
    from urban_road_filter_torch.utils import profiling

    group = request.getfixturevalue("nccl") if kind == "sp-nccl" else None
    call, cache, shape = _entry_calls(
        dev, "batch-pinned" if kind == "batch-pinned" else kind.split("-")[0],
        group)
    kind = kind.split("-")[0]
    plain = [call(s) for s in (3, 5)]
    (entry,) = [e for k, e in cache.items()
                if k[0] == kind and k[4] == shape and k[-1] == dev]
    graph, nodes = entry.graph, _build.graph_nodes(entry.graph)
    assert nodes == entry.stats["nodes"]
    captures, traced = dict(pl.CAPTURE_COUNTS), dict(pl.TRACED_CAPTURES)
    traced[kind] += entry.traced is None  # captured once an entry
    profiling.flush()
    record = profiling.replay_record().get(kind, {"timed": 0})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]):
        for want, seed in zip(plain, (3, 5)):
            _build.reset_launch_counts()
            got = call(seed)
            torch.cuda.synchronize()
            assert _build.launch_counts() == {
                k: entry.launches.get(k, 0) for k in _build.KERNELS}
            _assert_same(got, want)
    assert pl.CAPTURE_COUNTS == captures
    assert pl.TRACED_CAPTURES == traced
    assert entry.graph is graph and _build.graph_nodes(graph) == nodes
    assert _build.graph_nodes(entry.traced[0]) == nodes
    assert entry.traced_stats["nodes"] == nodes
    _assert_same(call(3), plain[0])
    profiling.flush()
    got = profiling.replay_record()[kind]
    assert got["timed"] == record["timed"] + 2
    assert got["untimed"] == record.get("untimed", 0)
    assert tuple(got["stage_ms"]) == TRACED_STAGES[kind]
    stages = {k: ms - record.get("stage_ms", {}).get(k, 0.0)
              for k, ms in got["stage_ms"].items()}
    assert all(ms > 0 for ms in stages.values()), stages
    replay = got["replay_ms"] - record.get("replay_ms", 0.0)
    assert sum(stages.values()) <= replay + 1e-6, (stages, replay)


# ---- the ring geometry after K6 (csrc/ring_geometry.cu) ----

def _drive_layout(dev, sensor, seed, n, rings):
    """(x, y, counts) of one emulated 2048-firing drive scan as tensorize
    places it at 2048 slots a ring (the benchmark's configurations)."""
    from urban_road_filter_torch.io import make_drive

    cfg = FilterConfig()
    scan = next(make_drive(1, sensor=sensor, seed=seed, firings=2048))
    pts = torch.from_numpy(pad_scan(scan, n)).to(dev)
    x, y, z, _ = geometry.xyz_of(pts, "rows")
    x, y, z = x.contiguous(), y.contiguous(), z.contiguous()
    valid = geometry.roi_mask_xyz(x, y, z, cfg)
    _, alpha = geometry.vertical_angles(x, y, z)
    angles, _ = geometry.discover_rings(alpha, valid, cfg.interval, rings)
    ring_id = geometry.assign_rings(alpha, valid, angles, cfg.interval)
    layout, _, _ = geometry.tensorize(x, y, z, ring_id, 2048, rings=rings)
    return layout.x, layout.y, layout.counts


@pytest.fixture(scope="module")
def ring_layouts(dev):
    """{case: (x, y, counts)} on the card: the CPU tests' cases
    (tests/ring_geometry_cases.py), a layout of 61 slots a ring (the
    kernel's one-slot path: rows off 16-byte alignment) and an OS1-64 and
    an OS1-128 drive scan at 64 and 128 rings x 2048 slots."""
    out = {c: ring_geometry_case(c, dev) for c in RING_CASES}
    out["61 slots"] = placed("two_curbs", 3, 61, device=dev)
    out["os1-64"] = _drive_layout(dev, "os1_64", 41, 131072, 64)
    out["os1-128"] = _drive_layout(dev, "os1_128", 31, 262144, 128)
    return out


@pytest.mark.parametrize("planes", ["all", "max"])
@pytest.mark.parametrize("case", [*RING_CASES, "61 slots", "os1-64",
                                  "os1-128"])
def test_ring_geometry_kernel(dev, ring_layouts, case, planes):
    """The ring geometry kernel bit-equal to its plain twin on the card on
    every plane it writes (d2, alpha with its NaNs, label, pid) and on
    max_distance, in each form its callers use (every plane; d2, alpha and
    the max), one launch a call; on the twin's CPU cases, a
    ragged row length and OS1-64 and OS1-128 drive scans."""
    x, y, counts = ring_layouts[case]
    fills = planes == "all"
    before = _build.launch_counts()["ring_geometry"]
    got = geometry.ring_geometry(x, y, counts, fills)
    assert _build.launch_counts()["ring_geometry"] == before + 1
    want = geometry.ring_geometry_plain(x, y, counts, fills)
    assert [t is None for t in got] == [t is None for t in want]
    assert [t is None for t in got] == [
        False, False, not fills, not fills, False]
    _assert_same(tuple(t for t in got if t is not None),
                 tuple(t for t in want if t is not None))
    _assert_same(tuple(t for t in got if t is not None), tuple(
        t for t, g in zip(glue_of_record(x, y, counts), got)
        if g is not None))
    torch.cuda.synchronize()


def test_ring_geometry_in_the_graphs(dev, ring_layouts):
    """The glue the kernel replaced is gone from process_scan's and
    process_batch's device ops: each makes as many fewer as the glue made,
    less the kernel's one (the glue's own count: its plain twin's device
    ops on the scan's layout)."""
    pts = torch.from_numpy(pad_scan(make_scan(
        SCENES["two_curbs"](), n_rings=24, n_azimuth=384, seed=0),
        N)).to(dev)
    planes = _lane_planes(dev)
    x, y, counts = ring_layouts["scan"]
    glue = _build.device_ops(
        lambda: geometry.ring_geometry_plain(x, y, counts))
    assert glue >= 30, glue
    assert _build.device_ops(
        lambda: geometry.ring_geometry(x, y, counts)) == 1
    calls = (lambda: process_scan(pts, FilterConfig(), LANE_DIMS),
             lambda: process_batch(planes, FilterConfig(), LANE_DIMS,
                                   layout="planar"))
    for call in calls:
        ops = _build.device_ops(call)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(geometry, "ring_geometry", geometry.ring_geometry_plain)
            assert _build.device_ops(call) == ops + glue - 1


@pytest.fixture(scope="module")
def glue_outputs(dev, os1_64_batches):
    """The entry points' outputs as the glue made them (ring_geometry's
    plain twin on the card and star labels in a fresh plane, the eager
    entries): one OS1-64 scan, lane batch 0 of os1_64_batches and an
    8-wedge SP scan, with their inputs on the card."""
    from urban_road_filter_torch import pipeline as pl
    from urban_road_filter_torch.parallel.azimuth_parallel import (
        azimuth_sorted, make_azimuth_pipeline)

    cfg = FilterConfig()
    scan = os1_64_batches[0][0].to(dev)
    batch = os1_64_batches[0].to(dev)
    sp_dims = PipelineDims(max_points=8192, rings=RINGS, ring_capacity=CAP)
    sp_pts = torch.from_numpy(pad_scan(azimuth_sorted(make_scan(
        SCENES["two_curbs"](), n_rings=16, n_azimuth=384, seed=11)),
        sp_dims.max_points)).to(dev)
    run = make_azimuth_pipeline(8, cfg, sp_dims)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(geometry, "ring_geometry", geometry.ring_geometry_plain)
        mp.setattr(pl, "star_labels", star_labels_of_record)
        _build.reset_launch_counts()
        want = {"scan": process_scan(scan, cfg, OS1_64),
                "batch": process_batch(batch, cfg, OS1_64),
                "sp": run.eager(sp_pts)}
        torch.cuda.synchronize()
        assert _build.launch_counts()["ring_geometry"] == 0
    return want, scan, run, sp_pts


def test_ring_geometry_entries_equal_the_glue(dev, os1_64_batches,
                                              glue_outputs):
    """process_scan_jit, the pinned process_batch_jit (lane groups) and
    the compiled SP run, through the kernel, bit-equal on every field to
    the same entries' outputs under the glue it replaced."""
    from urban_road_filter_torch import process_batch_jit, process_scan_jit

    want, scan, run, sp_pts = glue_outputs
    cfg = FilterConfig()
    _assert_same(process_scan_jit(scan, cfg, OS1_64), want["scan"])
    _assert_same(process_batch_jit(os1_64_batches[0], cfg, OS1_64),
                 want["batch"])
    run(sp_pts)  # the capture, after one eager run
    _assert_same(run(sp_pts), want["sp"])
    _assert_same(run.eager(sp_pts), want["sp"])


def test_ring_geometry_launches_per_entry(dev, os1_64_batches, glue_outputs):
    """Ring geometry launches credited per call: one a scan replay, one a
    lane group of the pinned batch (4 for 128 lanes), two an SP scan
    (sp_tensorize and sort_by_azimuth), replayed or eager."""
    from urban_road_filter_torch import pipeline as pl
    from urban_road_filter_torch import process_batch_jit, process_scan_jit

    _, scan, run, sp_pts = glue_outputs
    cfg = FilterConfig()
    groups = len(pl.lane_groups(128, pl.LANE_GROUP))
    assert groups == 4
    calls = [(1, lambda: process_scan_jit(scan, cfg, OS1_64)),
             (groups, lambda: process_batch_jit(os1_64_batches[0], cfg,
                                                OS1_64)),
             (2, lambda: run(sp_pts)), (2, lambda: run.eager(sp_pts))]
    for _, fn in calls:
        fn()  # captured
    torch.cuda.synchronize()
    for want, fn in calls:
        _build.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        assert _build.launch_counts()["ring_geometry"] == want
