"""Inputs and the record of the tensorize stage's glue for the ring
geometry (urban_road_filter_torch/csrc/ring_geometry.cu and its plain twin
``geometry.ring_geometry_plain``) and for the star labels, shared by the CPU tests
(tests/test_torch_ops.py) and the card's (tests/test_torch_kernels_gpu.py).
Imports neither JAX nor the JAX package."""

import numpy as np
import torch

from urban_road_filter_torch import FilterConfig
from urban_road_filter_torch.constants import LABEL_CURB
from urban_road_filter_torch.io import SCENES, make_scan
from urban_road_filter_torch.ops import geometry

F32 = np.float32
CASES = ("scan", "batch", "sp", "edges")


def glue_of_record(x, y, counts):
    """The tensorize stage's glue before the ring geometry kernel, op for
    op: geometry.azimuth_2d, the label and pid fills and max_distance, on
    x/y's device."""
    d2 = torch.sqrt((x * x + y * y).double()).float()
    x64, y64 = x.double(), y.double()
    r = torch.sqrt(x64 * x64 + y64 * y64).to(torch.float32)
    bracket = torch.clamp(torch.abs(x) / r, -1.0, 1.0)
    asin_deg = torch.asin(bracket.double()) * (180.0 / np.pi)
    alpha = torch.where(
        (x >= 0) & (y <= 0), asin_deg,
        torch.where((x >= 0) & (y > 0), 180.0 - asin_deg,
                    torch.where((x < 0) & (y >= 0), 180.0 + asin_deg,
                                360.0 - asin_deg))).to(torch.float32)
    slot = torch.arange(x.shape[-1], device=x.device)
    return geometry.RingGeometry(
        d2, alpha, torch.zeros(x.shape, dtype=torch.int32, device=x.device),
        torch.full(x.shape, -1, dtype=torch.int32, device=x.device),
        torch.amax(torch.where(slot < counts[..., None], d2, 0.0), dim=-1))


def star_labels_of_record(hp, ring_id, pos, label):
    """The tensorize stage's star labels before the ring geometry kernel:
    a fresh plane of zeros with a dump slot, LABEL_CURB index-filled at
    each landed hit's (ring, slot); ``label`` gives only the shape."""
    rings, cap = label.shape[-2:]
    n = ring_id.shape[-1]
    lead = hp.shape[:-1]
    plane = rings * cap
    h = torch.clamp(hp - 1, 0, n - 1).long()
    ring = torch.gather(ring_id, -1, h).long()
    slot = torch.gather(pos, -1, h).long()
    landed = (hp > 0) & (ring < rings) & (slot < cap)
    lanes = int(np.prod(lead))
    at = ring * cap + slot
    if lanes > 1:
        at = at + torch.arange(lanes, device=hp.device).view(
            *lead, 1) * plane
    dst = torch.where(landed, at, lanes * plane)
    lab = torch.zeros((lanes * plane + 1,), dtype=torch.int32,
                      device=hp.device)
    lab.index_fill_(0, dst.reshape(-1), LABEL_CURB)
    return lab[:lanes * plane].view(*lead, rings, cap)


def same_bits(got, want):
    """Equal shapes, dtypes and bits; NaN where the other has NaN (any
    NaN)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))


def placed(scene, seed, cap, rings=64, device="cpu"):
    """(x, y, counts) of a scene's layout (24 rings x 384 azimuths) as
    tensorize places it."""
    cfg = FilterConfig()
    pts = torch.from_numpy(make_scan(SCENES[scene](), n_rings=24,
                                     n_azimuth=384, seed=seed)).to(device)
    x, y, z = (pts[:, k].contiguous() for k in range(3))
    valid = geometry.roi_mask_xyz(x, y, z, cfg)
    _, av = geometry.vertical_angles(x, y, z)
    angles, _ = geometry.discover_rings(av, valid, cfg.interval, rings)
    ring_id = geometry.assign_rings(av, valid, angles, cfg.interval)
    layout, _, _ = geometry.tensorize(x, y, z, ring_id, cap, rings=rings)
    return layout.x, layout.y, layout.counts


def ring_geometry_case(case, device="cpu"):
    """(x, y, counts) planes of one case: "scan" (R, P); "batch" (B, R, P)
    with an empty lane; "sp" (wedges * R, P); rows at capacity in each;
    "edges", hand-made rows: an empty row, quadrant edges (x or y +-0.0
    beside each sign of the other), NaN coordinates, -0.0 in a tail, an
    f32 overflow, counts past P.  Every slot past a row's count holds
    +-0.0, as K6 leaves it."""
    if case == "scan":
        return placed("blind_spot", 1, 64, device=device)
    if case in ("batch", "sp"):
        lanes = [placed(s, k, 96, device=device) for k, s in enumerate(
            ("two_curbs", "wall", "curb_gap"))]
        if case == "batch":  # and an empty lane
            lanes.append(tuple(torch.zeros_like(a) for a in lanes[0]))
            return tuple(torch.stack(f) for f in zip(*lanes))
        return tuple(torch.cat(f) for f in zip(*lanes))  # wedges x rings
    nan, z, big = np.nan, -0.0, 3.4e38
    xy = np.zeros((5, 8, 2), F32)
    xy[1] = [(0, 0), (z, 5), (0, 5), (3, 0), (-3, 0), (-3, z), (3, z),
             (z, -5)]
    xy[2, :6] = [(nan, 1), (1, nan), (nan, nan), (z, z), (-2, -2), (z, z)]
    xy[3, :3] = [(1e-45, 0), (-1e-45, 1e-45), (big, big)]
    xy[4] = [(-1, -2), (2, -1), (-2, 1), (1, 2), (0, -1), (-1, 0), (z, 1),
             (1, z)]
    counts = np.array([0, 8, 5, 3, 12], np.int32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (xy[..., 0], xy[..., 1], counts))
