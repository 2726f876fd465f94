"""One scan in, labels + markers out: the single-scan pipeline on tensors.

Port of urban_road_filter_tpu/pipeline.py:99-212 (process_scan) and
:271-296 (the packed wire plane).  Dataflow, on the device of the input:

    points (rows (N, >=3) or planar (3, N), named by ``layout``)
      -> ROI mask, vertical angles, ring discovery + binning (ops.geometry)
      -> star-shaped search: <= 360 curb hits (K4 ops.star), when
         cfg.star_shaped_method
      -> stable rank + placement into (rings, P), input order, the star
         hits scattered onto it        (K5 ops.rank, K6 ops.place)
      -> x-zero / z-zero curb stencils (K7 ops.stencil_kernels)
      -> blind-spot flood fill, with the markers' first pass
                                       (K8, K9 ops.blind_spots)
      -> markers on the unsorted layout (K10 ops.markers)
      -> labels back to input order, gated and packed (K11 ops.gather)

Nothing here reads a value back to the host, so a CUDA scan is enqueued
without a synchronisation.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from urban_road_filter_tpu.config import FilterConfig, PipelineDims
from urban_road_filter_tpu.constants import MIN_POINTS
from urban_road_filter_torch.ops import geometry
from urban_road_filter_torch.ops.blind_spots import blind_spots
from urban_road_filter_torch.ops.gather import gather_pack
from urban_road_filter_torch.ops.markers import marker_points
from urban_road_filter_torch.ops.star import star_hits, star_labels
from urban_road_filter_torch.ops.stencil_kernels import fused_xz_zero

I32 = torch.int32


def _stage(name: str):
    """A named profiler range ("urf::<stage>"), read by
    tools/profile_torch_scan.py; near free when no profiler runs."""
    return torch.profiler.record_function(f"urf::{name}")


class ScanResult(NamedTuple):
    """Per-scan outputs (all fixed-shape; the host slices by masks)."""

    ok: torch.Tensor  # 0-d bool: >= 30 points in ROI (lidar_segmentation.cpp:124)
    roi: torch.Tensor  # (N,) bool
    labels: torch.Tensor  # (N,) int8 in {0,1,2}; 0 for non-ROI points
    ring_id: torch.Tensor  # (N,) int32; dims.rings = dropped at binning
    num_rings: torch.Tensor  # 0-d int32
    counts: torch.Tensor  # (dims.rings,) int32
    max_distance: torch.Tensor  # (dims.rings,) f32
    markers: torch.Tensor  # (361, 6): exists, x, y, z, red, bin
    overflow: torch.Tensor  # 0-d int32: points dropped by ring capacity
    star_overflow: torch.Tensor  # 0-d int32, always 0 (schema of the JAX
    # package, whose star path keeps every point per beam)
    probably_road: torch.Tensor  # (N,) bool: cfg.probably_road_ring members


def _scan(pts, cfg: FilterConfig, dims: PipelineDims, layout: str):
    """(ScanResult, packed uint8 plane) of one scan."""
    if pts.dtype != torch.float32:
        raise TypeError(f"points must be float32, got {pts.dtype}")
    x, y, z, _ = geometry.xyz_of(pts, layout)
    rings = dims.rings

    with _stage("ingest"):
        valid = geometry.roi_mask_xyz(x, y, z, cfg)
        ok = torch.sum(valid) >= MIN_POINTS
        _, alpha_v = geometry.vertical_angles(x, y, z)
        angles, num_rings = geometry.discover_rings(
            alpha_v, valid, cfg.interval, rings=rings)
        ring_id = geometry.assign_rings(alpha_v, valid, angles, cfg.interval)
    hp = None
    if cfg.star_shaped_method:
        with _stage("star"):
            hp = star_hits(x, y, z, valid, cfg)
    with _stage("tensorize"):
        rl, pos = geometry.tensorize(x, y, z, ring_id, dims.ring_capacity,
                                     rings=rings)
        max_dist = geometry.max_distance(rl)
        if hp is not None:
            rl = rl._replace(label=star_labels(hp, ring_id, pos, rings,
                                               dims.ring_capacity))
    with _stage("xz_zero"):
        rl = fused_xz_zero(rl, cfg)
    with _stage("blind_spots"):
        rl, kf = blind_spots(rl, max_dist, num_rings, cfg)
    with _stage("markers"):
        markers = marker_points(rl, num_rings, kf)
    with _stage("gather"):
        labels, roi, probably_road, packed = gather_pack(
            rl.label, ring_id, pos, valid, ok, int(cfg.probably_road_ring))
        markers = torch.where(ok, markers, 0.0)
    res = ScanResult(
        ok=ok, roi=roi, labels=labels, ring_id=ring_id, num_rings=num_rings,
        counts=rl.counts, max_distance=max_dist, markers=markers,
        overflow=rl.overflow,
        star_overflow=torch.zeros((), dtype=I32, device=pts.device),
        probably_road=probably_road)
    return res, packed


def process_scan(pts: torch.Tensor, cfg: FilterConfig, dims: PipelineDims,
                 layout: str = "rows") -> ScanResult:
    """Label one padded scan: ``layout="rows"`` for (N, >=3) points
    (pad_scan), ``"planar"`` for (3, N) coordinate planes
    (pad_scan_planar).  The orientation is never guessed from the shape."""
    return _scan(pts, cfg, dims, layout)[0]


def packed_scan(pts: torch.Tensor, cfg: FilterConfig, dims: PipelineDims,
                layout: str = "rows"):
    """process_scan with the three per-point planes packed into ONE uint8
    plane: labels in bits 0-1, roi in bit 2, probably_road in bit 3 (the
    JAX package's wire format).  Returns (packed, markers, ok, num_rings,
    overflow); unpack with unpack_planes."""
    res, packed = _scan(pts, cfg, dims, layout)
    return packed, res.markers, res.ok, res.num_rings, res.overflow


def unpack_planes(packed):
    """Inverse of packed_scan's plane packing, on a host array or a tensor:
    (labels uint8, roi bool, probably_road bool)."""
    return packed & 3, (packed & 4) != 0, (packed & 8) != 0


def pad_scan(points, n: int) -> np.ndarray:
    """Host helper: pad/truncate (M, 4) to (n, 4) float32; zero rows are
    dropped by the ROI filter exactly like real missing returns."""
    pts = np.zeros((n, 4), np.float32)
    m = min(len(points), n)
    pts[:m, : points.shape[1]] = points[:m, :4]
    return pts


def pad_scan_planar(points, n: int) -> np.ndarray:
    """pad_scan's planar twin: (M, >=3) -> (3, n) float32 x/y/z planes."""
    pts = np.zeros((3, n), np.float32)
    m = min(len(points), n)
    pts[:, :m] = np.asarray(points, np.float32)[:m, :3].T
    return pts
