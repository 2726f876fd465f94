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
The planes computed from the placed x/y (d2, alpha, the label and pid
fills) and each ring's max radius come from one kernel after K6
(ring_geometry, csrc/ring_geometry.cu).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from urban_road_filter_torch import _build
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


class RingGeometry(NamedTuple):
    """The layout planes computed from the placed x/y (ring_geometry)."""

    d2: torch.Tensor  # (..., P) f32 2-D radius
    alpha: torch.Tensor  # (..., P) f32 2-D azimuth, degrees
    label: torch.Tensor | None  # (..., P) int32 zeros
    pid: torch.Tensor | None  # (..., P) int32 -1
    max_distance: torch.Tensor  # (...,) f32 max d2 of a row's points


def _row_max(d2, counts) -> torch.Tensor:
    """Per-row max of d2 over the row's first ``counts`` slots; 0 if none."""
    slot = torch.arange(d2.shape[-1], device=d2.device)
    return torch.amax(torch.where(slot < counts[..., None], d2, 0.0), dim=-1)


def ring_geometry_plain(x, y, counts, fills: bool = True) -> RingGeometry:
    """The kernel's plain twin: azimuth_2d over every slot, the label and
    pid fills and the per-row max."""
    d2, alpha = azimuth_2d(x, y)
    label = pid = None
    if fills:
        label = torch.zeros(x.shape, dtype=I32, device=x.device)
        pid = torch.full(x.shape, -1, dtype=I32, device=x.device)
    return RingGeometry(d2, alpha, label, pid, _row_max(d2, counts))


def ring_geometry(x, y, counts, fills: bool = True) -> RingGeometry:
    """d2, alpha and each row's max_distance of placed (..., P) x/y
    planes whose row r holds its points in slots 0 .. counts[r] - 1 and
    +0.0 past them (K6's layout); with ``fills`` the label (0) and pid (-1)
    planes.  A CUDA tensor goes through csrc/ring_geometry.cu, one launch
    over the stacked rows, which writes the empty slots' values (d2 0,
    alpha NaN) without reading them; a CPU tensor through
    ring_geometry_plain."""
    if _build.on_cpu(x):
        return ring_geometry_plain(x, y, counts, fills)
    lead, p = x.shape[:-1], x.shape[-1]
    dev = x.device
    _build.check(x, "x", F32)
    _build.check(y, "y", F32, x.shape, dev)
    _build.check(counts, "counts", I32, lead, dev)
    d2, alpha = torch.empty_like(x), torch.empty_like(x)
    maxd = torch.empty(lead, dtype=F32, device=dev)
    label = pid = None
    if fills:
        label = torch.empty(x.shape, dtype=I32, device=dev)
        pid = torch.empty(x.shape, dtype=I32, device=dev)

    def ptr(t):
        return None if t is None else _build.ptr(t)

    _build.launch("ring_geometry", "urf_ring_geometry", dev, ptr(x), ptr(y),
                  ptr(counts), math.prod(lead), p, ptr(d2), ptr(alpha),
                  ptr(label), ptr(pid), _build.ptr(maxd))
    return RingGeometry(d2, alpha, label, pid, maxd)


def tensorize(x, y, z, ring_id, ring_capacity: int, rings: int = CHANNELS):
    """Stable placement into (rings, P), input order preserved per ring.
    Returns (RingLayout, pos, max_distance): pos[i] is point i's slot
    within its ring, so (ring_id, pos) addresses the layout and per-point
    results come back by gather (ops/gather.py); max_distance is
    max_distance(layout).  Only x/y/z are placed (K6); d2/alpha are
    recomputed on the layout, labels start at 0 and pid is not carried
    (-1), all in one ring_geometry launch.  With a leading lane axis (x, y,
    z, ring_id (B, N)) the outputs have it too: one rank (K5), one
    placement (K6) and one ring_geometry for the batch."""
    p = ring_capacity
    pos, counts_all = group_positions(ring_id, rings + 1)
    counts = torch.clamp(counts_all[..., :rings], max=p)
    lx, ly, lz, overflow = group_place(ring_id, pos, counts_all, (x, y, z),
                                       rings, p)
    g = ring_geometry(lx, ly, counts)
    layout = RingLayout(
        x=lx, y=ly, z=lz, d2=g.d2, alpha=g.alpha, label=g.label, pid=g.pid,
        counts=counts, overflow=overflow)
    return layout, pos, g.max_distance


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
    return _row_max(layout.d2, layout.counts)


def sort_by_azimuth(layout: RingLayout, carry_pid: bool = False) -> RingLayout:
    """Per-ring stable sort by azimuth (lidar_segmentation.cpp:70-93,
    289-291), the JAX package's geometry.sort_by_azimuth: the key is alpha
    on the first ``counts`` slots (a NaN azimuth sorts as 1e30: after every
    finite azimuth, before the +inf padding), x/y/z/label (and pid, with
    ``carry_pid``; else -1) ride along, d2/alpha are recomputed from the
    sorted x/y by ring_geometry (the first ``counts`` slots stay the
    points, the rest the layout's empty slots).  The JAX package leaves
    this sort to XLA; here it is one stable torch.sort per call over the
    ring rows."""
    key = torch.where(_slot_valid(layout),
                      torch.where(torch.isnan(layout.alpha), 1e30,
                                  layout.alpha), math.inf)
    order = torch.sort(key, dim=1, stable=True).indices

    def take(a):
        return torch.gather(a, 1, order)

    xs, ys = take(layout.x), take(layout.y)
    g = ring_geometry(xs, ys, layout.counts, fills=False)
    pid = (take(layout.pid) if carry_pid
           else torch.full_like(layout.pid, -1))
    return layout._replace(x=xs, y=ys, z=take(layout.z), d2=g.d2,
                           alpha=g.alpha, label=take(layout.label), pid=pid)
