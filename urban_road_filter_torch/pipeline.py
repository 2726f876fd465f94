"""Scans in, labels + markers out: the scan and batch pipelines on tensors.

Port of urban_road_filter_tpu/pipeline.py:99-212 (process_scan), :234-306
(the batch path, process_batch_jit) and :271-296 (the packed wire plane).
Dataflow, on the card (or, for ``device="cpu"``, through the plain twins):

    points (one scan: rows (N, >=3) or planar (3, N); a batch: rows
    (B, N, >=3) or planar (3, B, N); named by ``layout``)
      -> ingest, once over the (B, N) streams (B = 1 for one scan):
         ROI mask, star keys, in-ROI count (K1), vertical angles, ring
         discovery (K2) and binning (K3)   (ops.ingest)
    then per scan:
      -> star-shaped search: <= 360 curb hits (K4 ops.star), when
         cfg.star_shaped_method
      -> stable rank + placement into (rings, P), input order, the star
         hits scattered onto it        (K5 ops.rank, K6 ops.place)
      -> x-zero / z-zero curb stencils (K7 ops.stencil_kernels)
      -> blind-spot flood fill, with the markers' first pass
                                       (K8, K9 ops.blind_spots)
      -> markers on the unsorted layout (K10 ops.markers)
    then once over the batch:
      -> labels back to input order, gated and packed (K11 ops.gather;
         one launch per 128 scans)

Nothing here reads a value back to the host, so a CUDA scan or batch is
enqueued without a synchronisation.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from urban_road_filter_torch.config import FilterConfig, PipelineDims
from urban_road_filter_torch.constants import MIN_POINTS
from urban_road_filter_torch.ops import geometry, ingest
from urban_road_filter_torch.ops.blind_spots import blind_spots
from urban_road_filter_torch.ops.gather import gather_pack, gather_pack_batch
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


def _stages(x, y, z, valid, keys, ring_id, num_rings, cfg: FilterConfig,
            dims: PipelineDims):
    """(label table, pos, counts, max_distance, markers, overflow) of one
    scan after the ingest, up to its markers; keys are its star keys (fk,
    r_key), None with the star search off."""
    rings = dims.rings
    hp = None
    if keys is not None:
        with _stage("star"):
            hp = star_hits(x, y, z, valid, cfg, keys)
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
    return rl.label, pos, rl.counts, max_dist, markers, rl.overflow


def _ingest(x, y, z, cfg: FilterConfig, dims: PipelineDims):
    """(valid, fk, r_key, ring_id, num_rings, ok) of the scans of (B, N)
    coordinate views: K1-K3 once over the batch; fk and r_key are None with
    the star search off."""
    if x.dtype != torch.float32:
        raise TypeError(f"points must be float32, got {x.dtype}")
    with _stage("ingest"):
        valid, fk, r_key, piece = ingest.ingest_prep(
            x, y, z, cfg, want_star_keys=bool(cfg.star_shaped_method))
        _, alpha = geometry.vertical_angles(x, y, z)
        angles, num_rings = ingest.discover_rings(alpha, valid, cfg.interval,
                                                  dims.rings)
        ring_id = ingest.assign_rings(alpha, valid, angles, cfg.interval)
    return valid, fk, r_key, ring_id, num_rings, piece >= MIN_POINTS


def target_device(device=None) -> torch.device:
    """The device the entry points run on: ``device=None`` means "cuda".
    Without a CUDA device that raises unless the caller asked for the CPU
    (``device="cpu"``), the only way to run the plain twins."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch twins on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_device(pts, device=None) -> torch.Tensor:
    """The entry points' input on target_device(device); ``pts`` may be a
    tensor or a host array."""
    return torch.as_tensor(pts).to(target_device(device))


def _scan(pts, cfg: FilterConfig, dims: PipelineDims, layout: str, device):
    """(ScanResult, packed uint8 plane) of one scan: the batch path's
    kernels at B = 1 (the ingest over a batch of one, the gather + pack of
    one lane), on the scan's own views."""
    x, y, z, _ = geometry.xyz_of(on_device(pts, device), layout)
    valid, fk, r_key, ring_id, num_rings, ok = (
        f if f is None else f[0]
        for f in _ingest(x[None], y[None], z[None], cfg, dims))
    table, pos, counts, max_dist, markers, overflow = _stages(
        x, y, z, valid, None if fk is None else (fk, r_key), ring_id,
        num_rings, cfg, dims)
    with _stage("gather"):
        labels, roi, probably_road, packed = gather_pack(
            table, ring_id, pos, valid, ok, int(cfg.probably_road_ring))
        markers = torch.where(ok, markers, 0.0)
    res = ScanResult(
        ok=ok, roi=roi, labels=labels, ring_id=ring_id, num_rings=num_rings,
        counts=counts, max_distance=max_dist, markers=markers,
        overflow=overflow,
        star_overflow=torch.zeros((), dtype=I32, device=x.device),
        probably_road=probably_road)
    return res, packed


def process_scan(pts, cfg: FilterConfig, dims: PipelineDims,
                 layout: str = "rows", device=None) -> ScanResult:
    """Label one padded scan: ``layout="rows"`` for (N, >=3) points
    (pad_scan), ``"planar"`` for (3, N) coordinate planes
    (pad_scan_planar).  The orientation is never guessed from the shape.
    Runs on ``device`` (default "cuda"; "cpu" for the plain twins), where
    the points are moved first.  On the card, issue one device's scans
    from one stream at a time: K1 and K9 count their blocks with
    per-device tickets, and a launch on a second stream while the first
    is still busy raises (_build.TICKETED)."""
    return _scan(pts, cfg, dims, layout, device)[0]


def packed_scan(pts, cfg: FilterConfig, dims: PipelineDims,
                layout: str = "rows", device=None):
    """process_scan with the three per-point planes packed into ONE uint8
    plane: labels in bits 0-1, roi in bit 2, probably_road in bit 3 (the
    JAX package's wire format).  Returns (packed, markers, ok, num_rings,
    overflow); unpack with unpack_planes."""
    res, packed = _scan(pts, cfg, dims, layout, device)
    return packed, res.markers, res.ok, res.num_rings, res.overflow


def process_batch(pts, cfg: FilterConfig, dims: PipelineDims,
                  layout: str = "rows", device=None) -> ScanResult:
    """Label a batch of padded scans: ``layout="rows"`` for (B, N, >=3)
    points, ``"planar"`` for (3, B, N) coordinate planes (planarize_batch).
    The ingest (K1-K3) runs once over the (B, N) streams, the stages up to
    the markers per scan on views of them, and the gather + pack (K11)
    once over the batch; nothing reads a value back to the host.  Returns
    a ScanResult with a leading B axis on every field (ok, num_rings,
    overflow and star_overflow are (B,); markers (B, 361, 6)): the per-point
    fields are the gather's (B, N) outputs themselves, so lane b of a field
    is a view of the batch's tensor (writing into it writes into the
    batch).  Lane b equals process_scan of scan b.  ``device`` and the
    one-stream rule as for process_scan."""
    x, y, z, _ = geometry.xyz_of(on_device(pts, device), layout,
                                 batched=True)
    if x.shape[0] == 0:
        raise ValueError(f"empty batch: {tuple(pts.shape)}")
    valid, fk, r_key, ring_id, num_rings, ok = _ingest(x, y, z, cfg, dims)
    tables, pos, counts, max_dist, markers, overflow = zip(*(
        _stages(x[b], y[b], z[b], valid[b],
                None if fk is None else (fk[b], r_key[b]), ring_id[b],
                num_rings[b], cfg, dims)
        for b in range(x.shape[0])))
    with _stage("gather"):
        labels, roi, probably_road, _ = gather_pack_batch(
            tables, ring_id, pos, valid, ok, int(cfg.probably_road_ring))
        markers = torch.where(ok[:, None, None], torch.stack(markers), 0.0)
    return ScanResult(
        ok=ok, roi=roi, labels=labels, ring_id=ring_id, num_rings=num_rings,
        counts=torch.stack(counts), max_distance=torch.stack(max_dist),
        markers=markers, overflow=torch.stack(overflow),
        star_overflow=torch.zeros(ok.shape, dtype=I32, device=x.device),
        probably_road=probably_road)


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


def pad_scan_planar(points, n: int, out: np.ndarray | None = None
                    ) -> np.ndarray:
    """pad_scan's planar twin: (M, >=3) -> (3, n) float32 x/y/z planes,
    written into ``out`` (a (3, n) float32 array, e.g. a pinned buffer's
    view) when given."""
    m = min(len(points), n)
    src = np.asarray(points, np.float32)[:m, :3].T
    if out is None:
        out = np.zeros((3, n), np.float32)
    else:
        out[:, m:] = 0.0
    out[:, :m] = src
    return out


def planarize_batch(batch) -> np.ndarray:
    """Host helper: (B, N, >=3) row-major batch -> contiguous (3, B, N)
    float32 planes."""
    return np.ascontiguousarray(
        np.asarray(batch, np.float32)[..., :3].transpose(2, 0, 1))
