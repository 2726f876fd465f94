"""Marker-point extraction (reference: lidar_segmentation.cpp:295-351).

Port of urban_road_filter_tpu/ops/marker_scan.py:
marker_points_unsorted_pallas (K10), the sort-free form of ops/markers.py.
The reference walks each ring in azimuth order, rings outward; per
one-degree bin b = floor(alpha) it keeps the farthest road point (strict
``d > maxDistance``: ties keep the first point, cpp:329) and stops the bin
at its first non-road point (cpp:317-339).  Without sorting the layout,
"scan order" is the order of the key

    key = (ring << 48) | (bits(alpha) << 16) | slot

(a non-negative float's bits order like its value; equal azimuths keep
input order, as the reference's stable sort does), so per bin:

  kf[b]    = min key of a non-road point   (on CUDA computed inside the
             flood fill, ops/blind_spots.py, K9, or by its own kernel
             ``marker_first_nonroad``, K13, replacing
             marker_scan._marker_f_kernel, when marker_points gets no kf:
             one launch, its first block writing kf's initial value)
  maxd[b]  = max d2 of road points with key < kf[b]
  winner   = min key among those at maxd[b]

A CUDA layout goes through the hand-written kernel csrc/markers.cu (one
cooperative launch: per-block partials of (maxd, winner key) per bin, a
grid barrier, then a merge that keeps the larger d and, at equal d, the
smaller key; a batch's (B, R, P) layout is one launch, partials and merge
per lane, a lane's key counting rings within the lane); a CPU layout
through the plain twin below (``scatter_reduce`` over the bins, per
lane).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from urban_road_filter_torch.constants import LABEL_ROAD
from urban_road_filter_torch import _build
from urban_road_filter_torch.ops.geometry import F32, I32, RingLayout

N_BINS = 361  # i = 0..360 inclusive (lidar_segmentation.cpp:305)
NO_KEY = torch.iinfo(torch.int64).max  # "no point in this bin"
I64 = torch.int64


def marker_keys(alpha: torch.Tensor) -> torch.Tensor:
    """(..., R, P) int64 scan-order keys (ring << 48 | bits(alpha) << 16 |
    slot), the ring counted within its lane; meaningful where 0 <= alpha
    <= 360."""
    r, p = alpha.shape[-2:]
    dev = alpha.device
    bits = (alpha + 0.0).view(I32).to(I64) & 0xFFFFFFFF  # -0.0 -> +0.0
    ring = torch.arange(r, dtype=I64, device=dev)[:, None] << 48
    return ring | (bits << 16) | torch.arange(p, dtype=I64, device=dev)


def _bins(layout: RingLayout, num_rings):
    """(a_ok, bin_of): slots with a valid azimuth on an active ring, and
    each slot's bin (N_BINS, the dump bin, where not a_ok)."""
    alpha, counts = layout.alpha, layout.counts
    r, p = alpha.shape[-2:]
    dev = alpha.device
    num_rings = torch.as_tensor(num_rings, device=dev)
    valid = (torch.arange(p, device=dev) < counts[..., None]) & (
        torch.arange(r, device=dev)[:, None] < num_rings[..., None, None])
    a_ok = valid & (alpha >= 0) & (alpha <= 360.0)
    bin_of = torch.where(a_ok, torch.floor(alpha).to(I64), N_BINS)
    return a_ok, bin_of


def _reduce(mask, bin_of, src, how: str, init):
    """Per-bin reduction of (..., R, P) src over mask, (..., N_BINS + 1)
    with the dump bin last."""
    lead = src.shape[:-2]
    out = torch.full((*lead, N_BINS + 1), init, dtype=src.dtype,
                     device=src.device)
    idx = torch.where(mask, bin_of, N_BINS).reshape(*lead, -1)
    return out.scatter_reduce_(-1, idx, src.reshape(*lead, -1), how)


def _at_bins(table, bin_of):
    """table[..., bin_of]: each slot's entry of its lane's (..., N_BINS + 1)
    per-bin table."""
    lead = bin_of.shape[:-2]
    return torch.gather(table, -1, bin_of.reshape(*lead, -1)).view(
        bin_of.shape)


def first_nonroad_keys(layout: RingLayout, num_rings) -> torch.Tensor:
    """(361,) int64 kf: per bin, the key of the first non-road point in
    scan order, NO_KEY where the bin has none (the plain twin of K13 and of
    the marker pass fused into K9); (B, 361) for a batch's layout."""
    a_ok, bin_of = _bins(layout, num_rings)
    nonroad = a_ok & (layout.label != LABEL_ROAD)
    return _reduce(nonroad, bin_of, marker_keys(layout.alpha), "amin",
                   NO_KEY)[..., :N_BINS]


def marker_first_nonroad(layout: RingLayout,
                         num_rings: torch.Tensor) -> torch.Tensor:
    """first_nonroad_keys through its kernel on a CUDA layout (K13): one
    launch that writes kf's initial value itself (its first block, by a
    ticket), so one device op a call.  Its tickets are per-device
    counters: issue one device's calls from one stream at a time (a
    launch on a second stream while the first is busy raises,
    _build.TICKETED)."""
    if _build.on_cpu(layout.alpha):
        return first_nonroad_keys(layout, num_rings)
    if layout.alpha.ndim != 2:
        raise ValueError("marker_first_nonroad (K13) takes one scan's "
                         "(R, P) layout")
    r, p = layout.alpha.shape
    dev = layout.alpha.device
    _build.check_marker_dims(r, p)
    _build.check(layout.alpha, "alpha", F32, (r, p), dev)
    _build.check(layout.label, "label", I32, (r, p), dev)
    _build.check(layout.counts, "counts", I32, (r,), dev)
    _build.check(num_rings, "num_rings", I32, (), dev)
    kf = torch.empty((N_BINS,), dtype=I64, device=dev)  # the launch fills it
    _build.launch("marker_first_nonroad", "urf_marker_first_nonroad", dev,
                  _build.ptr(layout.alpha), _build.ptr(layout.label),
                  _build.ptr(layout.counts), _build.ptr(num_rings), r, p,
                  _build.ptr(kf))
    return kf


def marker_points_plain(layout: RingLayout, num_rings, kf) -> torch.Tensor:
    a_ok, bin_of = _bins(layout, num_rings)
    key = marker_keys(layout.alpha)
    d = layout.d2
    lead = d.shape[:-2]
    p = d.shape[-1]
    no = torch.full((*lead, 1), NO_KEY, dtype=I64, device=kf.device)
    cand = ((layout.label == LABEL_ROAD) & a_ok & (d > 0)
            & (key < _at_bins(torch.cat([kf, no], -1), bin_of)))
    maxd = _reduce(cand, bin_of, d, "amax", 0.0)
    winner = cand & (d == _at_bins(maxd, bin_of))
    wkey = _reduce(winner, bin_of, key, "amin", NO_KEY)[..., :N_BINS]
    exists = maxd[..., :N_BINS] > 0
    ring = torch.where(exists, wkey >> 48, 0)
    slot = torch.where(exists, wkey & 0xFFFF, 0)

    def pick(a):  # a[ring, slot] of each lane
        return torch.where(exists, torch.gather(
            a.reshape(*lead, -1), -1, ring * p + slot), 0.0)

    bins = torch.arange(N_BINS, dtype=F32, device=d.device).expand(
        exists.shape)
    return torch.stack([exists.to(F32), pick(layout.x), pick(layout.y),
                        pick(layout.z), (kf != NO_KEY).to(F32), bins],
                       dim=-1)


def marker_points(layout: RingLayout, num_rings: torch.Tensor,
                  kf: torch.Tensor | None = None) -> torch.Tensor:
    """Dense (361, 6) table [exists, x, y, z, red, bin] from the unsorted
    (tensorize-order) layout after the flood fill.  num_rings: 0-d int32;
    kf: (361,) int64 from ops.blind_spots.blind_spots, or None to compute
    it here (K13, the JAX marker_points_unsorted_pallas(kf=None); one
    scan).  With a leading lane axis (layout (B, R, P), num_rings (B,), kf
    (B, 361)): (B, 361, 6), lane b the table of lane b, from one launch."""
    if kf is None:
        kf = marker_first_nonroad(layout, num_rings)
    if _build.on_cpu(layout.alpha):
        return marker_points_plain(layout, num_rings, kf)
    *lead, r, p = layout.alpha.shape
    lanes = math.prod(lead)
    dev = layout.alpha.device
    _build.check_marker_dims(r, p)
    for name in ("x", "y", "z", "alpha", "d2"):
        _build.check(getattr(layout, name), name, F32, (*lead, r, p), dev)
    _build.check(layout.label, "label", I32, (*lead, r, p), dev)
    _build.check(layout.counts, "counts", I32, (*lead, r), dev)
    _build.check(num_rings, "num_rings", I32, tuple(lead), dev)
    _build.check(kf, "kf", I64, (*lead, N_BINS), dev)
    # Per-lane partials: (lanes, 361, parts) uint64 keys then uint32
    # distances, every entry written by the kernel, which cuts a lane into
    # at most max(r, 1) parts.
    blocks = max(r, 1)
    scratch = torch.empty((3 * N_BINS * lanes * blocks,), dtype=I32,
                          device=dev)
    table = torch.empty((*lead, N_BINS, 6), dtype=F32, device=dev)
    _build.launch("marker_points", "urf_marker_points", dev,
                  *(_build.ptr(getattr(layout, f)) for f in
                    ("x", "y", "z", "alpha", "d2", "label", "counts")),
                  _build.ptr(num_rings), _build.ptr(kf), r, p, lanes,
                  _build.ptr(scratch), blocks, _build.ptr(table))
    return table


def compact_markers(table) -> tuple:
    """Host helper: dense (361, 6) table -> (cM, 4) rows + bins, matching
    the oracle's marker_points/marker_bins.  A copy of the JAX package's
    ops/markers.py:compact_markers, whose module imports jax."""
    t = np.asarray(table)
    sel = t[:, 0] > 0
    rows = t[sel][:, [1, 2, 3, 4]].astype(np.float32)
    bins = t[sel][:, 5].astype(np.int32)
    return rows, bins
