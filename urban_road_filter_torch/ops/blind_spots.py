"""Blind-spot guard + road flood fill (reference: blind_spots.cpp:7-284).

Port of urban_road_filter_tpu/ops/blind_spots.py.  The two sweeps over 361
integer start angles only read curb labels and only write road labels, so
the stage is a pure reachability computation over the INITIAL curb marks:

    blocked[k, i] = any curb on ring k within window_k(i)
    reach[k, i]   = active(i) & ~gate(i) & AND_{m<=k} ~blocked[m, i]
    road(point p on ring k) = EXISTS i: reach[k, i] & p in window_k(i)

The two existential quantifiers are the kernels of csrc/flood.cu:
``flood_blocked`` (K8, replacing flood_scan.blocked_pallas; one launch
over any number of azimuth wedges, the sharded path's stacked layout) and
``flood_labeled`` (K9, replacing flood_scan.labeled_markerf_pallas), which
also returns the marker stage's per-bin first non-road key ``kf``
(ops/markers.py), or ``flood_road`` (K12, replacing
flood_scan.labeled_pallas), the road mask alone, which the unfused path
(``blind_spots(want_marker_f=False)``) and the azimuth-sharded path run.
The kernels of K9 and K12 find the starts whose window holds a slot as an
interval (fl(i +- w_k) is monotone in i), by bisection, and test it against
prefix counts of the reach bits (csrc/flood.cu).  On a CPU layout each
runs its plain twin: the JAX package's dense compare-reduces over the
(ring, slot, start) cube (its non-TPU branch, :180-191), evaluated a few
rings at a time so the cube never exceeds ~16M elements.

Float semantics follow the C++ and the JAX package: integer starts compared
in f32, window bounds i +- w_k in f32, the `i == 360-beamZone` /
`i == beamZone` exact-equality special cases for rings k >= 1 only
(blind_spots.cpp:136-143,244-251).

A batch of scans has a leading lane axis on the layout ((B, R, P)), the
ring radii, windows and reach bits ((B, R, ...)) and num_rings ((B,)): the
glue below broadcasts over it (no loop over lanes), K8 takes the lanes as
wedges with a window row each, and K9 takes them as its grid's third axis,
each lane's marker keys counting rings within the lane.

The beam zone is a dynamic parameter: the kernels read it from device
memory (config.device_config's buffer), the glue takes it as a 0-d tensor
there (or a host scalar), and nothing here copies a host value to the
device or reads one back, so the stage can be captured in a CUDA graph.
"""

from __future__ import annotations

import math

import torch

from urban_road_filter_torch.config import FilterConfig
from urban_road_filter_torch.constants import LABEL_CURB, LABEL_ROAD
from urban_road_filter_torch import _build
from urban_road_filter_torch.ops.geometry import (
    F32, I32, RingLayout, f32, stacked_rows)
from urban_road_filter_torch.ops.numerics import param, param_tensor
from urban_road_filter_torch.ops.markers import (
    I64, N_BINS, first_nonroad_keys)

_NI = 362  # start angles 0..361 (361 used; one pad, as in the JAX package)
_CUBE = 1 << 24  # elements of one (rings, slots, starts) chunk


def _quadrant_extremes(alpha1, label1, valid1):
    """Extremal curb azimuths on arc #1 per quadrant (blind_spots.cpp:19-57),
    each (..., 1): one per lane of a batch's (..., P) rings.  Strict >/<
    updates against the 0/180/180/360 inits are preserved."""
    curb = valid1 & (label1 == LABEL_CURB)
    a = alpha1

    def mx(cond):
        return torch.amax(torch.where(curb & cond, a, -math.inf), dim=-1,
                          keepdim=True)

    def mn(cond):
        return torch.amin(torch.where(curb & cond, a, math.inf), dim=-1,
                          keepdim=True)

    r1 = (a >= 0) & (a < 90)
    r2 = (a >= 90) & (a < 180)
    r3 = (a >= 180) & (a < 270)
    r4 = ~(r1 | r2 | r3) & ~torch.isnan(a)
    zero = torch.zeros((), dtype=F32, device=a.device)
    q1 = torch.where(mx(r1) > 0, mx(r1), zero)
    q2 = torch.where(mn(r2) < 180, mn(r2), zero + 180)
    q3 = torch.where(mx(r3) > 180, mx(r3), zero + 180)
    q4 = torch.where(mn(r4) < 360, mn(r4), zero + 360)
    return q1, q2, q3, q4


def _gate(i_f, q, x_direction: int):
    """Blind-spot angular gate per start angle (blind_spots.cpp:77-99)."""
    q1, q2, q3, q4 = q
    if x_direction == 0:
        return ((q1 != 0) & (q4 != 360) & ((i_f <= q1) | (i_f >= q4))) | (
            (q2 != 180) & (q3 != 180) & (i_f >= q2) & (i_f <= q3))
    if x_direction == 1:
        return ((q2 != 180) & (i_f >= q2) & (i_f <= 270)) | (
            (q1 != 0) & ((i_f <= q1) | (i_f >= 270)))
    return ((q4 != 360) & ((i_f >= q4) | (i_f <= 90))) | (
        (q3 != 180) & (i_f <= q3) & (i_f >= 90))


def window_widths(max_dist: torch.Tensor, beam_zone) -> torch.Tensor:
    """Equal-arc-length window width per ring, degrees
    (blind_spots.cpp:65,142,251): w[0] = beamZone; w[k] = arcDistance /
    (maxDist_k * pi / 180); inf where a ring is empty (harmless: no points).
    w[0] is written on the device, from a 0-d tensor.  max_dist (R,), or
    (B, R) for a batch: each lane's widths from its own radii."""
    bz = param_tensor(beam_zone, max_dist.device)
    deg_len = max_dist * f32(math.pi) / 180.0
    arc_distance = deg_len[..., :1] * bz
    w = arc_distance / deg_len
    w[..., 0] = bz
    return w


def _edge(bz):
    """f32(360 - bz), the difference taken in float64 and rounded once (as
    the host did), on the device for a tensor."""
    if isinstance(bz, torch.Tensor):
        return (360.0 - bz.double()).float()
    return f32(360.0 - bz)


def sweep_active(beam_zone, direction: int, device) -> torch.Tensor:
    """(362,) bool: the starts one sweep takes (sweep_bounds' first
    output)."""
    bz = param(beam_zone)
    i_f = torch.arange(_NI, dtype=F32, device=device)
    if direction > 0:
        return i_f <= _edge(bz)
    return (i_f >= bz) & (i_f <= 360.0)


def sweep_bounds(w: torch.Tensor, beam_zone, direction: int):
    """(active, lo, hi) for one sweep; lo/hi are the ACTUAL per-(ring, start)
    inclusive window bounds, exact-equality overrides applied: (R, 362)
    for w (R,), (..., R, 362) for w (..., R)."""
    bz = param(beam_zone)
    rings = w.shape[-1]
    dev = w.device
    i_f = torch.arange(_NI, dtype=F32, device=dev)
    k_ge1 = torch.arange(rings, device=dev)[:, None] >= 1
    active = sweep_active(bz, direction, dev)
    if direction > 0:
        edge = _edge(bz)  # exact: 360 - bz rounded once, as in f32
        special = (i_f == edge)[None, :] & k_ge1
        lo = i_f.expand(*w.shape, _NI)
        hi = torch.where(special, 360.0, i_f + w[..., None])
    else:
        special = (i_f == bz)[None, :] & k_ge1
        hi = i_f.expand(*w.shape, _NI)
        lo = torch.where(special, 0.0, i_f - w[..., None])
    return active, lo, hi


def _ring_chunks(r: int, p: int):
    step = max(1, _CUBE // max(1, p * _NI))
    return [slice(k, min(r, k + step)) for k in range(0, r, step)]


def blocked_bits(alpha, curb, lo, hi):
    """blocked[k, i] = any curb point in [lo, hi] — dense compare-reduce.
    alpha/curb: (R, P); lo/hi: (R, NI).  NaN alphas never block (NaN
    compares false), matching the C++ walk stopping at NaN."""
    out = []
    for s in _ring_chunks(*alpha.shape):
        a = alpha[s, :, None]
        in_win = (a >= lo[s, None, :]) & (a <= hi[s, None, :])
        out.append(torch.any(in_win & curb[s, :, None], dim=1))
    return torch.cat(out)


def labeled_mask(alpha, a_ok, reach, lo, hi):
    """labeled[k, p] = exists i: reach[k, i] & alpha in [lo, hi] — dense."""
    out = []
    for s in _ring_chunks(*alpha.shape):
        a = alpha[s, :, None]
        in_win = (a >= lo[s, None, :]) & (a <= hi[s, None, :])
        out.append(torch.any(in_win & reach[s, None, :], dim=2))
    return torch.cat(out) & a_ok


def reach_of(blocked, active, gate, ring_active):
    """reach[k, i] = no blocked ring <= k, start active and not gated, ring
    active.  Computed as k < (first blocked ring), a plain min-reduce over
    the ring axis (the second to last; a batch's lanes lead)."""
    rings = blocked.shape[-2]
    ring_iota = torch.arange(rings, dtype=I32, device=blocked.device)
    first_blocked = torch.amin(
        torch.where(blocked & ring_active, ring_iota[:, None], rings),
        dim=-2)
    return ((ring_iota[:, None] < first_blocked[..., None, :])
            & (active & ~gate)[..., None, :] & ring_active)


def _slot_valid(layout: RingLayout) -> torch.Tensor:
    p = layout.alpha.shape[-1]
    return (torch.arange(p, device=layout.alpha.device)
            < layout.counts[..., None])


def _wedge_rows(layout: RingLayout, w, wedges):
    """(layout, D, R): the stacked (D * R, P) layout, the wedge count and
    the rings per wedge of a flood_blocked call (wedges=None: one (R, P)
    layout, or a batch's (B, R, P) layout, its lanes the wedges)."""
    if layout.alpha.ndim == 3 and wedges is None:
        wedges = layout.alpha.shape[0]
        layout = stacked_rows(layout)
    rows = layout.alpha.shape[0]
    rings = w.shape[-1]
    d = 1 if wedges is None else int(wedges)
    if d < 0 or rows != d * rings or w.shape[:-1] not in ((), (d,)):
        raise ValueError(f"a layout of {rows} rows is not {d} wedges of "
                         f"{rings} rings (w {tuple(w.shape)})")
    return layout, d, rings


def flood_blocked_plain(layout: RingLayout, w, beam_zone, wedges=None):
    one = layout.alpha.ndim == 2 and wedges is None
    layout, d, rings = _wedge_rows(layout, w, wedges)
    curb = _slot_valid(layout) & (layout.label == LABEL_CURB)
    out = []
    for direction in (+1, -1):
        lo, hi = (b.expand(d, rings, _NI).reshape(d * rings, _NI)
                  for b in sweep_bounds(w, beam_zone, direction)[1:])
        bits = blocked_bits(layout.alpha, curb, lo, hi)
        out.append(bits if one else bits.view(d, rings, _NI))
    return tuple(out)


def flood_blocked(layout: RingLayout, w: torch.Tensor, beam_zone,
                  wedges: int | None = None):
    """(blocked_fwd, blocked_bwd): any curb slot of ring k inside the
    forward / backward window of start i.  w: (R,) f32 window widths
    (window_widths).  wedges=None: layout (R, P), each result (R, 362).
    wedges=D: the stacked layout of D azimuth wedges of R rings, (D * R, P)
    with ring k of wedge j at row j * R + k, and w (R,), shared by the
    wedges (the SP path's), or (D, R), a row per wedge (any lane stride);
    each result (D, R, 362), equal to the D per-wedge
    calls stacked, from one launch.  A batch's (B, R, P) layout with w
    (B, R) is its B lanes as wedges."""
    if _build.on_cpu(layout.alpha):
        return flood_blocked_plain(layout, w, beam_zone, wedges)
    one = layout.alpha.ndim == 2 and wedges is None
    layout, d, r = _wedge_rows(layout, w, wedges)
    rows, p = layout.alpha.shape
    dev = layout.alpha.device
    _build.check(layout.alpha, "alpha", F32, (rows, p), dev)
    _build.check(layout.label, "label", I32, (rows, p), dev)
    _build.check(layout.counts, "counts", I32, (rows,), dev)
    w2 = w.expand(d, r)
    _build.check(w2, "w", F32, (d, r), dev, contiguous=False)
    if w2.stride(1) != 1:
        raise ValueError("w: expected unit stride along the rings")
    shape = (rows, _NI) if one else (d, r, _NI)
    bf = torch.empty(shape, dtype=torch.bool, device=dev)
    bb = torch.empty(shape, dtype=torch.bool, device=dev)
    bz = param_tensor(beam_zone, dev)
    _build.launch("flood_blocked", "urf_flood_blocked", dev,
                  _build.ptr(layout.alpha), _build.ptr(layout.label),
                  _build.ptr(layout.counts), _build.ptr(w2), w2.stride(0), d,
                  r, p, _build.ptr(bz), _build.ptr(bf), _build.ptr(bb))
    return bf, bb


def flood_road_plain(layout: RingLayout, reach_f, reach_b, w, beam_zone):
    """(..., R, P) road mask of a layout, or of a batch's (lanes leading),
    its rows stacked for the dense compare."""
    alpha = layout.alpha
    p = alpha.shape[-1]
    a_ok = (_slot_valid(layout) & torch.isfinite(alpha) & (alpha >= 0)
            & (alpha <= 360.0)).reshape(-1, p)

    def road(reach, direction):
        lo, hi = (b.reshape(-1, _NI)
                  for b in sweep_bounds(w, beam_zone, direction)[1:])
        return labeled_mask(alpha.reshape(-1, p), a_ok,
                            reach.reshape(-1, _NI), lo, hi)

    return (road(reach_f, +1) | road(reach_b, -1)).view(alpha.shape)


def flood_road(layout: RingLayout, reach_f, reach_b, w: torch.Tensor,
               beam_zone) -> torch.Tensor:
    """(R, P) bool road mask: a slot with a valid azimuth inside a reached
    window of either sweep (K12).  reach_f/reach_b: (R, 362) bool, already
    gated (reach_of); w: (R,) f32 window widths."""
    if _build.on_cpu(layout.alpha):
        return flood_road_plain(layout, reach_f, reach_b, w, beam_zone)
    r, p = layout.alpha.shape
    dev = layout.alpha.device
    _build.check(layout.alpha, "alpha", F32, (r, p), dev)
    _build.check(layout.counts, "counts", I32, (r,), dev)
    _build.check(w, "w", F32, (r,), dev)
    _build.check(reach_f, "reach_f", torch.bool, (r, _NI), dev)
    _build.check(reach_b, "reach_b", torch.bool, (r, _NI), dev)
    road = torch.empty((r, p), dtype=torch.bool, device=dev)
    bz = param_tensor(beam_zone, dev)
    _build.launch("flood_road", "urf_flood_road", dev,
                  _build.ptr(layout.alpha), _build.ptr(layout.counts),
                  _build.ptr(w), _build.ptr(reach_f), _build.ptr(reach_b),
                  r, p, _build.ptr(bz), _build.ptr(road))
    return road


def road_labels(label: torch.Tensor, road: torch.Tensor) -> torch.Tensor:
    """LABEL_ROAD on every road slot that is not a curb."""
    return torch.where(road & (label != LABEL_CURB), LABEL_ROAD, label)


def flood_labeled_plain(layout: RingLayout, reach_f, reach_b, w, beam_zone,
                        num_rings):
    label = road_labels(layout.label, flood_road_plain(
        layout, reach_f, reach_b, w, beam_zone))
    return label, first_nonroad_keys(layout._replace(label=label), num_rings)


def flood_labeled(layout: RingLayout, reach_f, reach_b, w, beam_zone,
                  num_rings):
    """(label, kf): the layout's labels with every reached non-curb slot
    set to LABEL_ROAD, and the (361,) int64 marker key of each bin's first
    non-road point (ops/markers.py).  reach_f/reach_b: (R, 362) bool,
    already gated (reach_of); num_rings: 0-d int32.  With a leading lane
    axis (layout (B, R, P), reach (B, R, 362), w (B, R), num_rings (B,)):
    label (B, R, P) and kf (B, 361), each lane's keys counting rings
    within the lane, from one launch."""
    if _build.on_cpu(layout.alpha):
        return flood_labeled_plain(layout, reach_f, reach_b, w, beam_zone,
                                   num_rings)
    *lead, r, p = layout.alpha.shape
    lanes = math.prod(lead)
    dev = layout.alpha.device
    _build.check_marker_dims(r, p)
    _build.check(layout.alpha, "alpha", F32, (*lead, r, p), dev)
    _build.check(layout.label, "label", I32, (*lead, r, p), dev)
    _build.check(layout.counts, "counts", I32, (*lead, r), dev)
    _build.check(w, "w", F32, (*lead, r), dev)
    _build.check(reach_f, "reach_f", torch.bool, (*lead, r, _NI), dev)
    _build.check(reach_b, "reach_b", torch.bool, (*lead, r, _NI), dev)
    _build.check(num_rings, "num_rings", I32, tuple(lead), dev)
    label = torch.empty_like(layout.label)
    kf = torch.empty((*lead, N_BINS), dtype=I64, device=dev)  # written whole
    bz = param_tensor(beam_zone, dev)
    _build.launch("flood_labeled", "urf_flood_labeled", dev,
                  _build.ptr(layout.alpha), _build.ptr(layout.label),
                  _build.ptr(layout.counts), _build.ptr(w),
                  _build.ptr(reach_f), _build.ptr(reach_b),
                  _build.ptr(num_rings), r, p, lanes, _build.ptr(bz),
                  _build.ptr(label), _build.ptr(kf))
    return label, kf


def sweep_reach(layout: RingLayout, blocked, w: torch.Tensor,
                num_rings: torch.Tensor, cfg: FilterConfig, q=None):
    """(reach_f, reach_b), each (R, 362) bool, from flood_blocked's bits:
    the blind-spot gate of ring 1's curbs and the ring-outward blocking.
    ``q``: the four quadrant extremes when the caller combined them (the
    azimuth-sharded path), else taken from this layout's ring 1.  A batch
    (layout (B, R, P), blocked (B, R, 362), num_rings (B,)) gives (B, R,
    362), each lane gated by its own ring 1 and its own ring count."""
    alpha, label = layout.alpha, layout.label
    r = alpha.shape[-2]
    dev = alpha.device
    ring_active = (torch.arange(r, device=dev)
                   < num_rings[..., None])[..., None]
    gate = torch.zeros((_NI,), dtype=torch.bool, device=dev)
    if cfg.blind_spots:
        if q is None:
            q = _quadrant_extremes(alpha[..., 1, :], label[..., 1, :],
                                   _slot_valid(layout)[..., 1, :])
        gate = _gate(torch.arange(_NI, dtype=F32, device=dev), q,
                     int(cfg.x_direction))
    return tuple(
        reach_of(b, sweep_active(cfg.beam_zone, d, dev), gate, ring_active)
        for b, d in zip(blocked, (+1, -1)))


def blind_spots(layout: RingLayout, max_dist: torch.Tensor,
                num_rings: torch.Tensor, cfg: FilterConfig,
                want_marker_f: bool = True):
    """The flood fill over the (unsorted) layout.  Order-free: every window
    test compares a slot's own azimuth against per-(ring, start) bounds.
    ``want_marker_f=True``: (layout with road labels, kf) through K8 + K9;
    kf feeds ops.markers.marker_points.  ``False``: the layout alone,
    through K8 + K12 (the JAX blind_spots' unfused branch; one scan).  A
    batch's layout (B, R, P), max_dist (B, R) and num_rings (B,) go through
    one K8 and one K9 launch, kf (B, 361)."""
    if not want_marker_f and layout.alpha.ndim != 2:
        raise ValueError("the unfused flood fill (K12) takes one scan's "
                         "(R, P) layout")
    w = window_widths(max_dist, cfg.beam_zone)
    blocked = flood_blocked(layout, w, cfg.beam_zone)
    reach_f, reach_b = sweep_reach(layout, blocked, w, num_rings, cfg)
    if not want_marker_f:
        road = flood_road(layout, reach_f, reach_b, w, cfg.beam_zone)
        return layout._replace(label=road_labels(layout.label, road))
    label, kf = flood_labeled(layout, reach_f, reach_b, w, cfg.beam_zone,
                              num_rings)
    return layout._replace(label=label), kf
