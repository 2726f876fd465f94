"""Ingest and geometry prep (reference layer L2), in PyTorch.

Port of urban_road_filter_tpu/ops/geometry.py: the ROI crop, vertical
angles, the input-order greedy ring registration and ring binning of one
scan (the B = 1 case of ops/ingest.py, kernels K2 and K3), and the stable
placement into the padded (rings, P) layout.  Every threshold is
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

from urban_road_filter_torch.constants import CHANNELS
from urban_road_filter_torch.ops import ingest
from urban_road_filter_torch.ops.numerics import (  # noqa: F401 (re-exported)
    F32, I32, f32, roi_mask_xyz, sqrt_rn)
from urban_road_filter_torch.ops.place import group_place
from urban_road_filter_torch.ops.rank import group_positions

_DEG = float(np.float32(180.0 / math.pi))
_DEG64 = 180.0 / math.pi  # np.degrees' factor


def xyz_of(pts: torch.Tensor, layout: str, batched: bool = False):
    """(x, y, z, n) of a scan in the named orientation: ``"rows"`` is
    (N, >=3) with one point per row (the pad_scan layout), ``"planar"`` is
    (3, N) coordinate planes (pad_scan_planar).  ``batched`` takes a batch
    of scans, (B, N, >=3) rows or (3, B, N) planar, and gives (B, N) views.
    The orientation is never guessed from the shape: a planar scan of 4
    points is (3, 4)."""
    ndim = 3 if batched else 2
    if pts.ndim != ndim:
        raise ValueError(f"points must be {ndim}-D, got shape "
                         f"{tuple(pts.shape)}")
    if layout == "rows":
        if pts.shape[-1] < 3:
            raise ValueError(f"rows points need >= 3 columns, got "
                             f"{tuple(pts.shape)}")
        return pts[..., 0], pts[..., 1], pts[..., 2], pts.shape[-2]
    if layout == "planar":
        if pts.shape[0] != 3:
            raise ValueError(f"planar points must be (3, {'B, ' * batched}N),"
                             f" got {tuple(pts.shape)}")
        return pts[0], pts[1], pts[2], pts.shape[-1]
    raise ValueError(f"layout must be 'rows' or 'planar', got {layout!r}")


def vertical_angles(x, y, z):
    """3-D range + vertical angle in degrees (lidar_segmentation.cpp:145-166)."""
    d = sqrt_rn(x * x + y * y + z * z)
    bracket = torch.clamp(torch.abs(z) / d, -1.0, 1.0)
    alpha = torch.where(z < 0, torch.acos(bracket) * _DEG,
                        torch.asin(bracket) * _DEG + 90.0)
    return d, alpha


def discover_rings(alpha, valid, interval, rings: int = CHANNELS):
    """Greedy ring registration (lidar_segmentation.cpp:168-197) of one
    scan: ops.ingest.discover_rings (K2) at B = 1.  Returns (ascending ring
    angles padded with +inf, ring count as a 0-d int32 tensor)."""
    angles, count = ingest.discover_rings(alpha[None], valid[None], interval,
                                          rings)
    return angles[0], count[0]


def assign_rings(alpha, valid, angles_sorted, interval):
    """First matching ring in ascending-angle order
    (lidar_segmentation.cpp:226-233) of one scan: ops.ingest.assign_rings
    (K3) at B = 1; rings (the table size) = dropped."""
    return ingest.assign_rings(alpha[None], valid[None], angles_sorted[None],
                               interval)[0]


def azimuth_2d(x, y):
    """2-D radius + [0, 360] azimuth, quadrant cases
    (lidar_segmentation.cpp:244-269).  d2 is the f32 root of the f32 sum
    of squares, as the JAX package has it.  The azimuth follows the
    oracle's recipe: the f32 bracket |x| / r with r the float64 root of the
    float64 squares rounded to f32, then asin, degrees (x 180/pi, np.degrees'
    float64 constant) and the quadrant offset in float64, rounded once to
    f32.  An f32 asin rounded before the offset can land one ulp below an
    integer degree where the oracle lands on it, and the flood fill's
    windows start at integer degrees."""
    d2 = sqrt_rn(x * x + y * y)
    x64, y64 = x.double(), y.double()
    r = torch.sqrt(x64 * x64 + y64 * y64).to(F32)
    bracket = torch.clamp(torch.abs(x) / r, -1.0, 1.0)
    asin_deg = torch.asin(bracket.double()) * _DEG64
    alpha = torch.where(
        (x >= 0) & (y <= 0), asin_deg,
        torch.where((x >= 0) & (y > 0), 180.0 - asin_deg,
                    torch.where((x < 0) & (y >= 0), 180.0 + asin_deg,
                                360.0 - asin_deg)))
    return d2, alpha.to(F32)


class RingLayout(NamedTuple):
    """Padded per-ring tensors, input order along the slot axis; a batch of
    scans has a leading lane axis on every field ((B, R, P) planes, (B, R)
    counts, (B,) overflow)."""

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
    on the layout, labels start at 0 and pid is not carried (-1).  With a
    leading lane axis (x, y, z, ring_id (B, N)) the layout and pos have it
    too: one rank (K5) and one placement (K6) for the batch."""
    p = ring_capacity
    lead = ring_id.shape[:-1]
    pos, counts_all = group_positions(ring_id, rings + 1)
    counts = torch.clamp(counts_all[..., :rings], max=p)
    lx, ly, lz, overflow = group_place(ring_id, pos, counts_all, (x, y, z),
                                       rings, p)
    ld2, lalpha = azimuth_2d(lx, ly)
    layout = RingLayout(
        x=lx, y=ly, z=lz, d2=ld2, alpha=lalpha,
        label=torch.zeros((*lead, rings, p), dtype=I32, device=x.device),
        pid=torch.full((*lead, rings, p), -1, dtype=I32, device=x.device),
        counts=counts, overflow=overflow)
    return layout, pos


def stacked_rows(layout: RingLayout) -> RingLayout:
    """A (B, R, P) layout as the (B * R, P) stacked layout of the same
    memory (views: a write into one is a write into the other), counts
    (B * R,); a (R, P) layout as it is."""
    if layout.x.ndim == 2:
        return layout
    p = layout.x.shape[-1]
    planes = {f: getattr(layout, f).view(-1, p)
              for f in ("x", "y", "z", "d2", "alpha", "label", "pid")}
    return layout._replace(counts=layout.counts.view(-1), **planes)


def _slot_valid(layout: RingLayout) -> torch.Tensor:
    p = layout.x.shape[-1]
    slot = torch.arange(p, device=layout.x.device)
    return slot < layout.counts[..., None]


def max_distance(layout: RingLayout) -> torch.Tensor:
    """Per-ring max 2-D radius (lidar_segmentation.cpp:271-274); 0 if empty."""
    return torch.amax(torch.where(_slot_valid(layout), layout.d2, 0.0),
                      dim=-1)


def sort_by_azimuth(layout: RingLayout, carry_pid: bool = False) -> RingLayout:
    """Per-ring stable sort by azimuth (lidar_segmentation.cpp:70-93,
    289-291), the JAX package's geometry.sort_by_azimuth: the key is alpha
    on the first ``counts`` slots (a NaN azimuth sorts as 1e30: after every
    finite azimuth, before the +inf padding), x/y/z/label (and pid, with
    ``carry_pid``; else -1) ride along, d2/alpha are recomputed from the
    sorted x/y.  The JAX package leaves this sort to XLA; here it is one
    stable torch.sort per call over the ring rows."""
    key = torch.where(_slot_valid(layout),
                      torch.where(torch.isnan(layout.alpha), 1e30,
                                  layout.alpha), math.inf)
    order = torch.sort(key, dim=1, stable=True).indices

    def take(a):
        return torch.gather(a, 1, order)

    xs, ys = take(layout.x), take(layout.y)
    d2s, als = azimuth_2d(xs, ys)
    pid = (take(layout.pid) if carry_pid
           else torch.full_like(layout.pid, -1))
    return layout._replace(x=xs, y=ys, z=take(layout.z), d2=d2s, alpha=als,
                           label=take(layout.label), pid=pid)
