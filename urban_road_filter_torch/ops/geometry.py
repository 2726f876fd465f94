"""Ingest and geometry prep (reference layer L2), in PyTorch.

Port of urban_road_filter_tpu/ops/geometry.py: the ROI crop, vertical
angles, the input-order greedy ring registration, ring binning and the
stable placement into the padded (rings, P) layout.  Every threshold is
rounded to float32 on the host first, as the JAX package does with
``jnp.asarray(v, float32)``.

Input order along the slot axis is load-bearing: the x/z-zero stencils
read it (lidar_segmentation.cpp:280-291), so placement is a stable rank
(ops/rank.py, kernel K5) followed by an indexed store (ops/place.py, K6).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from urban_road_filter_tpu.config import FilterConfig
from urban_road_filter_tpu.constants import CHANNELS
from urban_road_filter_torch.ops.place import group_place
from urban_road_filter_torch.ops.rank import group_positions

F32 = torch.float32
I32 = torch.int32

_DEG = float(np.float32(180.0 / math.pi))


def f32(v) -> float:
    """A host scalar rounded to float32, as a Python float (exact)."""
    return float(np.float32(v))


def sqrt_rn(v: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root, as XLA and CUDA's sqrtf give it.
    torch's vectorized CPU sqrt is not (it is off by an ulp on ~0.5 % of
    inputs); the float64 root rounded once to float32 is, on every device."""
    return torch.sqrt(v.double()).float()


def xyz_of(pts: torch.Tensor, layout: str):
    """(x, y, z, n) of a scan in the named orientation: ``"rows"`` is
    (N, >=3) with one point per row (the pad_scan layout), ``"planar"`` is
    (3, N) coordinate planes (pad_scan_planar).  The orientation is never
    guessed from the shape: a planar scan of 4 points is (3, 4)."""
    if pts.ndim != 2:
        raise ValueError(f"points must be 2-D, got shape {tuple(pts.shape)}")
    if layout == "rows":
        if pts.shape[1] < 3:
            raise ValueError(f"rows points need >= 3 columns, got "
                             f"{tuple(pts.shape)}")
        return pts[:, 0], pts[:, 1], pts[:, 2], pts.shape[0]
    if layout == "planar":
        if pts.shape[0] != 3:
            raise ValueError(f"planar points must be (3, N), got "
                             f"{tuple(pts.shape)}")
        return pts[0], pts[1], pts[2], pts.shape[1]
    raise ValueError(f"layout must be 'rows' or 'planar', got {layout!r}")


def roi_mask_xyz(x, y, z, cfg: FilterConfig) -> torch.Tensor:
    """Crop box + zero-point drop (lidar_segmentation.cpp:106-117)."""
    return ((x >= f32(cfg.min_x)) & (x <= f32(cfg.max_x))
            & (y >= f32(cfg.min_y)) & (y <= f32(cfg.max_y))
            & (z >= f32(cfg.min_z)) & (z <= f32(cfg.max_z))
            & (x + y + z != 0.0))


def vertical_angles(x, y, z):
    """3-D range + vertical angle in degrees (lidar_segmentation.cpp:145-166)."""
    d = sqrt_rn(x * x + y * y + z * z)
    bracket = torch.clamp(torch.abs(z) / d, -1.0, 1.0)
    alpha = torch.where(z < 0, torch.acos(bracket) * _DEG,
                        torch.asin(bracket) * _DEG + 90.0)
    return d, alpha


def discover_rings(alpha, valid, interval: float, rings: int = CHANNELS):
    """Greedy ring registration (lidar_segmentation.cpp:168-197) as a
    ``rings``-step loop of vectorized matching: ring k+1's representative is
    the first point matching none of rings 0..k.  Returns (ascending ring
    angles padded with +inf, ring count as a 0-d int32 tensor).  The loop
    never reads a value back to the host."""
    tol = f32(interval)
    dev = alpha.device
    inf = torch.full((1,), math.inf, dtype=F32, device=dev)
    angles = torch.full((rings,), math.inf, dtype=F32, device=dev)
    matched = torch.zeros_like(valid)
    count = torch.zeros((), dtype=I32, device=dev)
    for k in range(rings):
        unmatched = valid & ~matched
        # argmax returns the FIRST maximum; 0 (with unmatched[0] False)
        # when nothing is left.
        first = torch.argmax(unmatched.to(torch.uint8)).reshape(1)
        has = unmatched.index_select(0, first)
        a = alpha.index_select(0, first)
        angles[k:k + 1] = torch.where(has, a, inf)
        matched |= has & (torch.abs(alpha - a) <= tol)
        count += has.to(I32)[0]
    return torch.sort(angles).values, count


def assign_rings(alpha, valid, angles_sorted, interval: float):
    """First matching ring in ascending-angle order
    (lidar_segmentation.cpp:226-233); rings (the table size) = dropped."""
    rings = angles_sorted.shape[0]
    m = torch.abs(angles_sorted[None, :] - alpha[:, None]) <= f32(interval)
    has = torch.any(m, dim=1)
    ring = torch.argmax(m.to(torch.uint8), dim=1).to(I32)
    return torch.where(valid & has, ring, torch.full_like(ring, rings))


def azimuth_2d(x, y):
    """2-D radius + [0, 360] azimuth, quadrant cases
    (lidar_segmentation.cpp:244-269)."""
    d2 = sqrt_rn(x * x + y * y)
    bracket = torch.clamp(torch.abs(x) / d2, -1.0, 1.0)
    asin_deg = torch.asin(bracket) * _DEG
    alpha = torch.where(
        (x >= 0) & (y <= 0), asin_deg,
        torch.where((x >= 0) & (y > 0), 180.0 - asin_deg,
                    torch.where((x < 0) & (y >= 0), 180.0 + asin_deg,
                                360.0 - asin_deg)))
    return d2, alpha


class RingLayout(NamedTuple):
    """Padded per-ring tensors, input order along the slot axis."""

    x: torch.Tensor  # (R, P) f32
    y: torch.Tensor
    z: torch.Tensor
    d2: torch.Tensor
    alpha: torch.Tensor  # 2-D azimuth, degrees
    label: torch.Tensor  # (R, P) int32
    pid: torch.Tensor  # (R, P) int32 original point index; -1 = empty slot
    counts: torch.Tensor  # (R,) int32 points per ring
    overflow: torch.Tensor  # 0-d int32: points dropped by capacity


def tensorize(x, y, z, ring_id, ring_capacity: int, rings: int = CHANNELS):
    """Stable placement into (rings, P), input order preserved per ring.
    Returns (RingLayout, pos): pos[i] is point i's slot within its ring, so
    (ring_id, pos) addresses the layout and per-point results come back by
    gather (ops/gather.py).  Only x/y/z are placed; d2/alpha are recomputed
    on the layout, labels start at 0 and pid is not carried (-1)."""
    p = ring_capacity
    pos, counts_all = group_positions(ring_id, rings + 1)
    counts = torch.clamp(counts_all[:rings], max=p)
    lx, ly, lz, overflow = group_place(ring_id, pos, x, y, z, rings, p)
    ld2, lalpha = azimuth_2d(lx, ly)
    layout = RingLayout(
        x=lx, y=ly, z=lz, d2=ld2, alpha=lalpha,
        label=torch.zeros((rings, p), dtype=I32, device=x.device),
        pid=torch.full((rings, p), -1, dtype=I32, device=x.device),
        counts=counts, overflow=overflow)
    return layout, pos


def _slot_valid(layout: RingLayout) -> torch.Tensor:
    p = layout.x.shape[1]
    slot = torch.arange(p, device=layout.x.device)
    return slot[None, :] < layout.counts[:, None]


def max_distance(layout: RingLayout) -> torch.Tensor:
    """Per-ring max 2-D radius (lidar_segmentation.cpp:271-274); 0 if empty."""
    return torch.amax(torch.where(_slot_valid(layout), layout.d2, 0.0), dim=1)
