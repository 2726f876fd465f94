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

With ``wedges=D`` the call takes the sharded path's stacked layout, D
azimuth wedges of R rings ((D * R, P), ring k of wedge w at row w * R + k),
with (D, R) offsets and (D, 361) floors, and returns (D, 361, 6): the D
per-wedge calls stacked, from one launch.

A CUDA layout goes through the hand-written kernel csrc/markers.cu (one
cooperative launch, no fill); a CPU layout through the plain twin below
(``scatter_reduce`` over the wedges' bins).
"""

from __future__ import annotations

import ctypes

import torch

from urban_road_filter_torch import _build
from urban_road_filter_torch.constants import LABEL_ROAD
from urban_road_filter_torch.ops.geometry import F32, I32, RingLayout, sqrt_rn
from urban_road_filter_torch.ops.markers import I64, N_BINS

F_NONE = 3.0e38  # "no non-road point yet" (marker_scan._BIG), f32-exact
_G_LIMIT = 1 << 24  # g must stay f32-exact
_FLAT_LIMIT = 1 << 32  # the winner's flat slot rides in 32 bits of its key


def _wedge_shape(layout: RingLayout, wedges):
    """(D, R, P) of a call: wedges=None is one (R, P) layout."""
    rows, p = layout.alpha.shape
    d = 1 if wedges is None else int(wedges)
    if d <= 0 or rows % d:
        raise ValueError(f"a layout of {rows} rows is not {d} wedges")
    return d, rows // d, p


def marker_state_plain(layout: RingLayout, num_rings, g_offset=None,
                       f_init=None, wedges=None) -> torch.Tensor:
    d, r, p = _wedge_shape(layout, wedges)
    dev = layout.alpha.device
    if g_offset is None:
        g_offset = (torch.arange(r, dtype=I32, device=dev) * p).repeat(d)
    if f_init is None:
        f_init = torch.full((d, N_BINS), F_NONE, dtype=F32, device=dev)
    row = torch.arange(d * r, device=dev)
    wedge = (row // r)[:, None]
    nb = N_BINS + 1  # each wedge's bins, then its dump bin
    alpha, counts = layout.alpha, layout.counts
    valid = (torch.arange(p, device=dev)[None, :] < counts[:, None]) & (
        (row % r) < num_rings)[:, None]
    a_ok = valid & (alpha >= 0) & (alpha <= 360.0)
    bin_of = wedge * nb + torch.where(a_ok, torch.floor(alpha).to(I64),
                                      N_BINS)
    dump = (wedge * nb + N_BINS).expand(d * r, p)

    def reduce(mask, src, how, init):
        out = torch.full((d * nb,), init, dtype=src.dtype, device=dev)
        return out.scatter_reduce_(0, torch.where(mask, bin_of, dump)
                                   .reshape(-1), src.reshape(-1), how)

    g = g_offset.reshape(d * r).to(I64)[:, None] + torch.arange(
        p, dtype=I64, device=dev)
    gf = g.to(F32)
    road = layout.label == LABEL_ROAD
    f = torch.cat([f_init.reshape(d, N_BINS).to(F32),
                   f_init.new_full((d, 1), F_NONE)], 1).reshape(-1)
    f = f.scatter_reduce(0, torch.where(a_ok & ~road, bin_of, dump)
                         .reshape(-1), gf.reshape(-1), "amin")
    dist = sqrt_rn(layout.x * layout.x + layout.y * layout.y)
    cand = a_ok & road & (dist > 0) & (gf < f[bin_of])
    maxd = reduce(cand, dist, "amax", 0.0)
    flat = torch.arange(d * r * p, dtype=I64, device=dev).reshape(d * r, p)
    wkey = reduce(cand & (dist == maxd[bin_of]), (g << 32) | flat, "amin",
                  torch.iinfo(I64).max)

    def bins(t):
        return t.view(d, nb)[:, :N_BINS]

    maxd, wkey = bins(maxd), bins(wkey)
    exists = maxd > 0
    at = torch.where(exists, wkey & 0xFFFFFFFF, 0)

    def pick(a):
        return torch.where(exists, a.reshape(-1)[at], 0.0)

    state = torch.stack([bins(f), maxd,
                         torch.where(exists, (wkey >> 32).to(F32), 0.0),
                         pick(layout.x), pick(layout.y), pick(layout.z)],
                        dim=2)
    return state[0] if wedges is None else state


def marker_state(layout: RingLayout, num_rings: torch.Tensor,
                 g_offset: torch.Tensor | None = None,
                 f_init: torch.Tensor | None = None,
                 wedges: int | None = None) -> torch.Tensor:
    """(361, 6) f32 [f, maxd, gstar, x, y, z] from the azimuth-sorted
    layout (geometry.sort_by_azimuth).  num_rings: 0-d int32; g_offset:
    (R,) int32 per-ring scan-position offsets (default ring * P); f_init:
    (361,) f32 per-bin floors of f (default 3e38).  With wedges=D: the
    stacked (D * R, P) layout of D wedges, g_offset (D, R) (default ring *
    P in each wedge), f_init (D, 361) (rows may be a broadcast view), and a
    (D, 361, 6) result, equal to the D per-wedge calls stacked."""
    d, r, p = _wedge_shape(layout, wedges)
    if g_offset is None and r * p > _G_LIMIT:
        raise ValueError(f"scan positions of a ({r}, {p}) layout are not "
                         f"f32-exact")
    if _build.on_cpu(layout.alpha):
        return marker_state_plain(layout, num_rings, g_offset, f_init,
                                  wedges)
    if d * r * p > _FLAT_LIMIT:
        raise ValueError(f"{d} x ({r}, {p}) slots do not fit the kernel's "
                         f"32-bit slot index")
    dev = layout.alpha.device
    for name in ("x", "y", "z", "alpha"):
        _build.check(getattr(layout, name), name, F32, (d * r, p), dev)
    _build.check(layout.label, "label", I32, (d * r, p), dev)
    _build.check(layout.counts, "counts", I32, (d * r,), dev)
    _build.check(num_rings, "num_rings", I32, (), dev)
    goff = ctypes.c_void_p(None)
    if g_offset is not None:
        _build.check(g_offset, "g_offset", I32,
                     (r,) if wedges is None else (d, r), dev)
        goff = _build.ptr(g_offset)
    finit, f_stride = ctypes.c_void_p(None), 0
    if f_init is not None:
        _build.check(f_init, "f_init", F32,
                     (N_BINS,) if wedges is None else (d, N_BINS), dev,
                     contiguous=False)
        if f_init.stride(-1) != 1:
            raise ValueError("f_init: each wedge's row must be contiguous")
        finit = _build.ptr(f_init)
        f_stride = 0 if wedges is None else f_init.stride(0)
    # Per row group its f partials (361 padded to 364) and its (maxd, key)
    # partials (12 bytes per bin), then each wedge's merged f, every entry
    # written by the kernel before it is read; at most d * max(r, 1)
    # groups.
    groups = d * max(r, 1)
    scratch = torch.empty((groups * (364 + 3 * N_BINS) + N_BINS * d,),
                          dtype=I32, device=dev)
    state = torch.empty((d, N_BINS, 6), dtype=F32, device=dev)
    _build.launch("marker_state", "urf_marker_state", dev,
                  *(_build.ptr(getattr(layout, f)) for f in
                    ("x", "y", "z", "alpha", "label", "counts")),
                  _build.ptr(num_rings), goff, finit, f_stride, d, r, p,
                  _build.ptr(scratch), groups, _build.ptr(state))
    return state[0] if wedges is None else state
