"""Per-bin marker state on the azimuth-sorted layout (K14).

Port of urban_road_filter_tpu/ops/marker_scan.py:marker_state_pallas, the
marker kernel the azimuth-sharded path runs twice per wedge
(parallel/azimuth_parallel.py).  Each slot of the sorted layout has a scan
position g = g_offset[ring] + slot (default ring * P; the sharded path
passes ring * P_glob + the wedge's prefix, so g is the GLOBAL scan
position).  g rises along the reference's traversal, so the TPU kernel's
running per-bin state ends at an order-free reduction:

    f     = min(f_init, min g of the bin's non-road points)
    maxd  = max d over road points with d > 0 and g < f
    gstar = min g among those at maxd (the strict-> rule: ties keep the
            first point)
    x, y, z of that point

with d = sqrt(x*x + y*y) (marker_scan.py:86).  Bins without a candidate
keep maxd = gstar = x = y = z = 0, and f keeps f_init (3e38, the kernel's
"none yet" sentinel, marker_scan.py:44, by default).  Returns the (361, 6)
f32 table [f, maxd, gstar, x, y, z]: columns 0-5 of the JAX (384, 8) state.

A CUDA layout goes through the hand-written kernel csrc/markers.cu; a CPU
layout through the plain twin below (``scatter_reduce`` over the bins).
"""

from __future__ import annotations

import torch

from urban_road_filter_torch import _build
from urban_road_filter_torch.constants import LABEL_ROAD
from urban_road_filter_torch.ops.geometry import F32, I32, RingLayout, sqrt_rn
from urban_road_filter_torch.ops.markers import I64, N_BINS, _bins, _reduce

F_NONE = 3.0e38  # "no non-road point yet" (marker_scan._BIG), f32-exact
_G_LIMIT = 1 << 24  # g must stay f32-exact


def _offsets(layout: RingLayout, g_offset, f_init):
    r, p = layout.alpha.shape
    dev = layout.alpha.device
    if g_offset is None:
        g_offset = torch.arange(r, dtype=I32, device=dev) * p
    if f_init is None:
        f_init = torch.full((N_BINS,), F_NONE, dtype=F32, device=dev)
    return g_offset, f_init


def marker_state_plain(layout: RingLayout, num_rings, g_offset=None,
                       f_init=None) -> torch.Tensor:
    g_offset, f_init = _offsets(layout, g_offset, f_init)
    r, p = layout.alpha.shape
    dev = layout.alpha.device
    a_ok, bin_of = _bins(layout, num_rings)
    g = g_offset.to(I64)[:, None] + torch.arange(p, dtype=I64, device=dev)
    gf = g.to(F32)
    road = layout.label == LABEL_ROAD
    f = torch.cat([f_init.to(F32), f_init.new_full((1,), F_NONE)])
    f = f.scatter_reduce(0, torch.where(a_ok & ~road, bin_of, N_BINS)
                         .reshape(-1), gf.reshape(-1), "amin")
    d = sqrt_rn(layout.x * layout.x + layout.y * layout.y)
    cand = a_ok & road & (d > 0) & (gf < f[bin_of])
    maxd = _reduce(cand, bin_of, d, "amax", 0.0)
    flat = torch.arange(r * p, dtype=I64, device=dev).reshape(r, p)
    key = (g << 32) | flat
    wkey = _reduce(cand & (d == maxd[bin_of]), bin_of, key, "amin",
                   torch.iinfo(I64).max)[:N_BINS]
    exists = maxd[:N_BINS] > 0
    at = torch.where(exists, wkey & 0xFFFFFFFF, 0)

    def pick(a):
        return torch.where(exists, a.reshape(-1)[at], 0.0)

    return torch.stack([f[:N_BINS], maxd[:N_BINS],
                        torch.where(exists, (wkey >> 32).to(F32), 0.0),
                        pick(layout.x), pick(layout.y), pick(layout.z)],
                       dim=1)


def marker_state(layout: RingLayout, num_rings: torch.Tensor,
                 g_offset: torch.Tensor | None = None,
                 f_init: torch.Tensor | None = None) -> torch.Tensor:
    """(361, 6) f32 [f, maxd, gstar, x, y, z] from the azimuth-sorted
    layout (geometry.sort_by_azimuth).  num_rings: 0-d int32; g_offset:
    (R,) int32 per-ring scan-position offsets (default ring * P); f_init:
    (361,) f32 per-bin floors of f (default 3e38)."""
    r, p = layout.alpha.shape
    if g_offset is None and r * p > _G_LIMIT:
        raise ValueError(f"scan positions of a ({r}, {p}) layout are not "
                         f"f32-exact")
    if _build.on_cpu(layout.alpha):
        return marker_state_plain(layout, num_rings, g_offset, f_init)
    g_offset, f_init = _offsets(layout, g_offset, f_init)
    dev = layout.alpha.device
    for name in ("x", "y", "z", "alpha"):
        _build.check(getattr(layout, name), name, F32, (r, p), dev)
    _build.check(layout.label, "label", I32, (r, p), dev)
    _build.check(layout.counts, "counts", I32, (r,), dev)
    _build.check(num_rings, "num_rings", I32, (), dev)
    _build.check(g_offset, "g_offset", I32, (r,), dev)
    _build.check(f_init, "f_init", F32, (N_BINS,), dev)
    f_img = torch.empty((N_BINS,), dtype=I32, device=dev)
    maxd = torch.empty((N_BINS,), dtype=I32, device=dev)
    win = torch.empty((N_BINS,), dtype=I64, device=dev)
    state = torch.empty((N_BINS, 6), dtype=F32, device=dev)
    _build.launch("marker_state", "urf_marker_state", dev,
                  *(_build.ptr(getattr(layout, f)) for f in
                    ("x", "y", "z", "alpha", "label", "counts")),
                  _build.ptr(num_rings), _build.ptr(g_offset),
                  _build.ptr(f_init), r, p, _build.ptr(f_img),
                  _build.ptr(maxd), _build.ptr(win), _build.ptr(state))
    return state
