"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Needs a CUDA device (skips without one).  The same checks as phase 2 of
chip_smoke.py at small shapes: every kernel output bit-equal to its twin's
on the same CUDA tensors.  Run on a machine with the card (tests/conftest.py
imports jax, which a GPU host without JAX skips with --noconftest):

    python -m pytest tests/test_torch_kernels_gpu.py -q -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from star_streams import walk_streams

from urban_road_filter_torch import FilterConfig, _build, pad_scan
from urban_road_filter_torch.io import SCENES, make_scan
from urban_road_filter_torch.ops import geometry
from urban_road_filter_torch.ops import blind_spots as bs
from urban_road_filter_torch.ops import markers as mk
from urban_road_filter_torch.ops import star
from urban_road_filter_torch.ops.blind_spots import blind_spots
from urban_road_filter_torch.ops.gather import gather_pack, gather_pack_plain
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
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == w.dtype
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
    # max_len 3000: beams longer than the kernel's staging chunk.
    cfg = FilterConfig(**kw)
    streams = [torch.from_numpy(a).to(dev) for a in walk_streams(seed,
                                                                 max_len)]
    before = _build.launch_counts()["star_walk"]
    got = star.star_walk(*streams, cfg)
    assert _build.launch_counts()["star_walk"] == before + 1
    _assert_same((got,), (star.star_walk_plain(*streams, cfg),))
    assert int((got > 0).sum()) > 30


@pytest.mark.parametrize("kw", [dict(), dict(starbeam_filter=True)])
@pytest.mark.parametrize("scene", ["two_curbs", "wall"])
def test_star_hits_kernel(dev, scene, kw):
    cfg = FilterConfig(**kw)
    x, y, z, valid, _, _ = _rings(dev, scene, cfg=cfg)
    streams = star.beam_streams(x, y, z, valid, cfg)
    got = star.star_walk(*streams, cfg)
    _assert_same((got,), (star.star_walk_plain(*streams, cfg),))
    assert int((got > 0).sum()) > 30


@pytest.mark.parametrize("n,groups,seed", [(300, 5, 0), (4096, 65, 1),
                                           (5000, 361, 2), (131072, 65, 3)])
def test_rank_kernel(dev, n, groups, seed):
    ids = torch.from_numpy(np.random.default_rng(seed).integers(
        0, groups, n).astype(np.int32)).to(dev)
    before = _build.launch_counts()["group_rank"]
    _assert_same(group_positions(ids, groups),
                 group_positions_plain(ids, groups))
    assert _build.launch_counts()["group_rank"] == before + 1


@pytest.mark.parametrize("cap", [CAP, 64])
def test_place_kernel(dev, cap):
    x, y, z, _, ring_id, _ = _rings(dev)
    pos, _ = group_positions(ring_id, RINGS + 1)
    got = group_place(ring_id, pos, x, y, z, RINGS, cap)
    _assert_same(got, group_place_plain(ring_id, pos, x, y, z, RINGS, cap))
    assert (int(got[3]) > 0) == (cap == 64)


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


def test_wrappers_refuse_bad_inputs(dev):
    ids = torch.zeros(8, dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        group_positions(ids, 4)
    table = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    i32 = torch.zeros(8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # a CPU operand beside CUDA ones
        gather_pack(table, i32, i32.cpu(), i32 > 0,
                    torch.tensor(True, device=dev), 0)
