"""The plain reference: a frozen NumPy copy of the port's oracle.

Copied from urban_road_filter_torch/oracle/reference.py (itself a
re-implementation of the C++ node jkk-research/urban_road_filter, stage by
stage, with the C++ float32/float64 promotions), with the pieces of the
port's constants.py it reads.  It imports nothing of the program and takes
only the raw scans the benchmark made; the configuration is the "filter"
object of a configuration file, read by attribute (``filter_settings``).

Documented, deliberate divergences from the C++ (all measure-zero or UB):
  * unstable `std::sort`/quicksort tie order -> stable sorts here
    (equal azimuth / equal radius keys keep input order);
  * windowed float accumulations (z-zero va/vb sums, x-zero newY cumsum)
    are evaluated in float64 then rounded once, instead of replaying the C++
    sequential float32 rounding (<=1 ulp difference);
  * the reference's out-of-bounds reads (blind_spots.cpp:107,216) and the
    `alpha == 0` ring-sentinel quirk (lidar_segmentation.cpp:176) are not
    replicated -- both are UB / measure-zero;
  * libm vs numpy transcendental functions may differ in the last ulp.
"""

from __future__ import annotations

import dataclasses
import math
import types

import numpy as np

# Hard channel cap (lidar_segmentation.cpp:4).
CHANNELS = 64

# Number of star-shaped detection beams and their width in metres
# (star_shaped_search.cpp:8-9).
STAR_REP = 360
STAR_WIDTH = 0.2

# Kfi = rep / 2pi — sector index multiplier (star_shaped_search.cpp:65),
# stored as float32 like the reference's `float Kfi`.
STAR_KFI = np.float32(STAR_REP / (2.0 * math.pi))

# Minimum in-ROI points for a scan to be evaluated (lidar_segmentation.cpp:124).
MIN_POINTS = 30

# Labels (short isCurbPoint, data_structures.hpp:44).
LABEL_NONE = 0
LABEL_ROAD = 1
LABEL_CURB = 2

# The "probably road" output dumps ring #10 verbatim
# (lidar_segmentation.cpp:605-608).  Kept, but behind this knob.
PROBABLY_ROAD_RING = 10


def beam_tables(rep: int = STAR_REP, width: float = STAR_WIDTH):
    """Per-beam trig tables, mirroring beam_init (star_shaped_search.cpp:36-51).

    Returns (yx, d, o) arrays of shape (rep,):
      yx: True if the beam aligns more with the y-axis (|tan(fi)| > 1)
      d:  centerline coefficient (1/tan(fi) if yx else tan(fi))
      o:  half-beam-width projection (|off/sin(fi)| if yx else |off/cos(fi)|)
    Math follows the C++ float/double promotions: fi is float32 computed
    from double `i*2*M_PI/rep`; tan/sin/cos evaluated then stored as float32.
    """
    off = np.float64(0.5 * width)
    i = np.arange(rep, dtype=np.float64)
    fi = (i * 2.0 * math.pi / rep).astype(np.float32)
    tanfi = np.tan(fi.astype(np.float64))
    yx = np.abs(tanfi.astype(np.float32)) > 1.0
    with np.errstate(divide="ignore"):
        d = np.where(yx, np.tan(0.5 * math.pi - fi.astype(np.float64)),
                     np.tan(fi.astype(np.float64))).astype(np.float32)
        o = np.where(yx, np.abs(off / np.sin(fi.astype(np.float64))),
                     np.abs(off / np.cos(fi.astype(np.float64)))).astype(np.float32)
    return yx, d, o


def filter_settings(filter_cfg: dict):
    """The reference's view of a configuration file's "filter" object: its
    fields by attribute."""
    return types.SimpleNamespace(**filter_cfg)


F32 = np.float32
F64 = np.float64



@dataclasses.dataclass
class OracleResult:
    """Outputs of the reference pipeline for one scan."""

    ok: bool  # False iff <30 points in ROI (lidar_segmentation.cpp:124)
    roi_mask: np.ndarray  # (N,) bool — which input points are inside the ROI
    # Everything below is defined on ROI points, *in input order*:
    labels: np.ndarray  # (piece,) int16 in {0,1,2}
    ring_of_point: np.ndarray  # (piece,) int32, -1 = dropped at ring binning
    ring_angles: np.ndarray  # (index,) f32, ascending
    num_rings: int
    max_distance: np.ndarray  # (CHANNELS,) f32 per-ring max 2D radius
    # Per-ring sorted structure (for stage-level debugging/tests):
    ring_point_ids: list  # ring -> (n_i,) int ROI-point indices, azimuth-sorted
    ring_alpha: list  # ring -> (n_i,) f32 azimuth, sorted
    # Marker extraction (step 3, lidar_segmentation.cpp:295-351):
    marker_points: np.ndarray  # (cM, 4) f32: x, y, z, redPoints
    marker_bins: np.ndarray  # (cM,) int32 — which 1-degree bin each row came from
    # Output cloud index lists (ROI-point indices, reference publish order):
    road_ids: np.ndarray
    curb_ids: np.ndarray
    probably_road_ids: np.ndarray


# --------------------------------------------------------------------------
# Stage L2: ROI crop (lidar_segmentation.cpp:106-117, data_structures.hpp:90-108)
# --------------------------------------------------------------------------

def roi_mask(points: np.ndarray, cfg: types.SimpleNamespace) -> np.ndarray:
    """Box crop + drop of (0,0,0)-sum points; float32 comparisons."""
    x = points[:, 0].astype(F32)
    y = points[:, 1].astype(F32)
    z = points[:, 2].astype(F32)
    return (
        (x >= F32(cfg.min_x)) & (x <= F32(cfg.max_x))
        & (y >= F32(cfg.min_y)) & (y <= F32(cfg.max_y))
        & (z >= F32(cfg.min_z)) & (z <= F32(cfg.max_z))
        & (x + y + z != F32(0))
    )


# --------------------------------------------------------------------------
# Stage L2: 3-D range + vertical angle (lidar_segmentation.cpp:145-166)
# --------------------------------------------------------------------------

def vertical_angles(x: np.ndarray, y: np.ndarray, z: np.ndarray):
    """d = ||p||2 (f32 from f64 math), alpha = vertical angle in degrees."""
    d = np.sqrt(x.astype(F64) ** 2 + y.astype(F64) ** 2 + z.astype(F64) ** 2).astype(F32)
    with np.errstate(invalid="ignore", divide="ignore"):
        bracket = (np.abs(z.astype(F32)) / d).astype(F32)
    bracket = np.clip(bracket, F32(-1), F32(1))
    acos_deg = np.degrees(np.arccos(bracket.astype(F64)))
    asin_deg = np.degrees(np.arcsin(bracket.astype(F64)))
    alpha = np.where(z < 0, acos_deg, asin_deg + 90.0).astype(F32)
    return d, alpha


# --------------------------------------------------------------------------
# Stage L2: greedy ring discovery (lidar_segmentation.cpp:168-197)
# --------------------------------------------------------------------------

def discover_rings(alpha: np.ndarray, interval: float,
                   channels: int = CHANNELS) -> np.ndarray:
    """Greedy input-order ring registration, capped at `channels` rings.

    Equivalent reformulation of the per-point greedy loop: ring k+1's
    representative is the first (lowest-index) point not within `interval`
    of rings 0..k.  Returns representatives in registration order.

    `channels` mirrors the reference's compile-time constant
    (lidar_segmentation.cpp:4, `channels = 64`): a >64-beam deployment of
    the C++ would rebuild with it raised, so >64-ring configs (e.g. the
    OS1-128 dims pipeline) are oracle-checked with channels raised the
    same way.
    """
    interval = F32(interval)
    n = alpha.shape[0]
    matched = np.zeros(n, dtype=bool)
    reps = []
    while len(reps) < channels:
        unmatched = np.flatnonzero(~matched)
        if unmatched.size == 0:
            break
        a = alpha[unmatched[0]]
        reps.append(a)
        matched |= np.abs(alpha - a) <= interval
    return np.asarray(reps, dtype=F32)


# --------------------------------------------------------------------------
# Stage L3: star-shaped search (star_shaped_search.cpp:32-181)
# --------------------------------------------------------------------------

def star_shaped_search(x: np.ndarray, y: np.ndarray, z: np.ndarray,
                       labels: np.ndarray, cfg: types.SimpleNamespace,
                       edge_nudge: float = 0.0) -> None:
    """Marks labels[i] = 2 in place, exactly like beamfunc over 360 beams.

    edge_nudge: relative scale applied to the azimuth just before beam
    quantization (see run_oracle) — 0.0 is the exact reference semantics."""
    yx_t, d_t, o_t = beam_tables()
    # slope_param: f32(angleFilter3_f32 * (M_PI/180)) (star_shaped_search.cpp:160)
    slope_param = F32(F64(F32(cfg.curb_slope_deg)) * (math.pi / 180.0))
    kdev = F32(cfg.kdev_param)
    kdist = F32(cfg.kdist_param)
    dmin = int(cfg.dmin_param)

    # Polar binning (star_shaped_search.cpp:162-174): float32 r and fi.
    r = np.sqrt(x * x + y * y).astype(F32)
    # atan2 is the double libm function in the C++ (float args promoted),
    # rounded once on the float assignment — computing it in f32 directly
    # flips ~1-ulp beam-boundary cases (caught by the golden C++ harness).
    fi = np.arctan2(y.astype(F64), x.astype(F64)).astype(F32)
    neg = fi < 0  # note: -0.0 is NOT < 0, same as the C++
    fi = np.where(neg, (fi.astype(F64) + 2.0 * math.pi).astype(F32), fi)
    if edge_nudge:
        fi = (fi * F32(1.0 + edge_nudge)).astype(F32)
    f = (fi * STAR_KFI).astype(np.int32)  # truncation toward zero
    # f == rep IS reachable (fi a few ulps below 2pi rounds up through the
    # f32 multiply).  The C++ would dereference a NULL beamp[360] here —
    # beam_init fills 0..359 and the push_back sentinel lands at index 361
    # (star_shaped_search.cpp:20,51,157; PARITY.md item 5a).  We route such
    # points to beam 0, the evident intent of the sentinel.
    f %= STAR_REP

    order = np.argsort(f, kind="stable")  # beams accumulate points in input order
    boundaries = np.searchsorted(f[order], np.arange(STAR_REP + 1))

    for beam in range(STAR_REP):
        ids = order[boundaries[beam]:boundaries[beam + 1]]
        if ids.size == 0:
            continue
        if cfg.starbeam_filter:
            # Rectangle filter (star_shaped_search.cpp:73-107); strict <.
            c = (d_t[beam] * (y[ids] if yx_t[beam] else x[ids])).astype(F32)
            coord = x[ids] if yx_t[beam] else y[ids]
            keep = ((c - o_t[beam]) < coord) & (coord < (c + o_t[beam]))
            ids = ids[keep]
        s = ids.size
        if s <= 1:
            continue
        rs = r[ids]
        srt = np.argsort(rs, kind="stable")  # C++ std::sort is unstable; we pin ties
        ids = ids[srt]
        rs = rs[srt]
        zs = z[ids].astype(F32)
        hit = _beam_walk(rs, zs, slope_param, kdev, kdist, dmin)
        if hit >= 0:
            labels[ids[hit]] = LABEL_CURB


def _beam_walk(rs: np.ndarray, zs: np.ndarray, slope_param: F32,
               kdev: F32, kdist: F32, dmin: int) -> int:
    """Literal transcription of the edge-detection walk
    (star_shaped_search.cpp:111-151), float32 arithmetic throughout."""
    s = rs.shape[0]
    one = F32(1)
    avg = F32(0)
    dev = F32(0)
    nan = F32(0)
    bx = rs[0]
    by = zs[0]
    for i in range(1, s):
        ax = bx
        bx = rs[i]
        ay = by
        by = zs[i]
        with np.errstate(divide="ignore", invalid="ignore"):
            slp = F32((by - ay) / (bx - ax))
        if np.isnan(slp):
            nan += one
        else:
            # An INF slope (bx == ax without the divide guard tripping)
            # passes the isnan check and poisons avg/dev through
            # inf - inf = NaN, exactly like the C++ floats — keep the
            # values, silence only NumPy's RuntimeWarning.
            with np.errstate(invalid="ignore"):
                m = F32(i) - nan  # count of valid slopes incl. this one
                avg = avg * (m - one)
                avg = avg + slp
                avg = avg * (one / m)
                dev = dev * (m - one)
                dev = dev + np.abs(slp - avg)
                dev = dev * (one / m)
        with np.errstate(invalid="ignore"):
            trip = slp > slope_param or (
                i > dmin
                and (slp * slp - avg * avg) * kdev * ((bx - ax) * kdist) > dev
            )
        if trip:
            return i
    return -1


# --------------------------------------------------------------------------
# Stage L2: 2-D azimuth, quadrant cases (lidar_segmentation.cpp:244-269)
# --------------------------------------------------------------------------

def azimuth_2d(x: np.ndarray, y: np.ndarray):
    """2-D radius (f32 via f64 sqrt) and azimuth in [0, 360] degrees."""
    d2 = np.sqrt(x.astype(F64) ** 2 + y.astype(F64) ** 2).astype(F32)
    with np.errstate(invalid="ignore", divide="ignore"):
        bracket = (np.abs(x.astype(F32)) / d2).astype(F32)
    bracket = np.clip(bracket, F32(-1), F32(1))
    asin_deg = np.degrees(np.arcsin(bracket.astype(F64)))
    alpha = np.where(
        (x >= 0) & (y <= 0), asin_deg,
        np.where((x >= 0) & (y > 0), 180.0 - asin_deg,
                 np.where((x < 0) & (y >= 0), 180.0 + asin_deg, 360.0 - asin_deg)),
    ).astype(F32)
    return d2, alpha


# --------------------------------------------------------------------------
# Stage L3: x-zero method (x_zero_method.cpp:7-71)
# --------------------------------------------------------------------------

def _x_zero_ring(xs, ys, zs, label, cfg: types.SimpleNamespace) -> None:
    n = xs.shape[0]
    cp = int(cfg.curb_points)
    if n - 2 * cp < 1:
        return
    # newY[j]: 0.01-spaced synthetic Y (x_zero_method.cpp:24-27); float64
    # cumsum of the float32 increments, rounded once (documented divergence).
    new_y = (np.arange(n, dtype=F64) * 0.01).astype(F32)
    j = np.arange(cp, n - cp)  # j in [curbPoints, n-1-curbPoints]
    p2 = j + cp // 2
    p3 = j + cp
    d = np.sqrt((xs[p3] - xs[j]).astype(F64) ** 2 + (ys[p3] - ys[j]).astype(F64) ** 2).astype(F32)
    x1 = np.sqrt((new_y[p2] - new_y[j]).astype(F64) ** 2 + (zs[p2] - zs[j]).astype(F64) ** 2).astype(F32)
    x2 = np.sqrt((new_y[p3] - new_y[p2]).astype(F64) ** 2 + (zs[p3] - zs[p2]).astype(F64) ** 2).astype(F32)
    x3 = np.sqrt((new_y[p3] - new_y[j]).astype(F64) ** 2 + (zs[p3] - zs[j]).astype(F64) ** 2).astype(F32)
    with np.errstate(invalid="ignore", divide="ignore"):
        # numerator f64 (pow), denominator f32 (-2*x1*x2), ratio f64 -> f32
        bracket = (
            (x3.astype(F64) ** 2 - x1.astype(F64) ** 2 - x2.astype(F64) ** 2)
            / (F32(-2) * x1 * x2).astype(F64)
        ).astype(F32)
    bracket = np.clip(bracket, F32(-1), F32(1))
    alpha = np.degrees(np.arccos(bracket.astype(F64))).astype(F32)
    cond = (
        (d < 5.0)
        & (alpha <= F32(cfg.cylinder_deg_x))
        & ((np.abs(zs[j] - zs[p2]) >= F32(cfg.curb_height))
           | (np.abs(zs[p3] - zs[p2]) >= F32(cfg.curb_height)))
        & (np.abs(zs[j] - zs[p3]).astype(F64) >= 0.05)
    )
    label[p2[cond]] = LABEL_CURB


# --------------------------------------------------------------------------
# Stage L3: z-zero method (z_zero_method.cpp:5-76)
# --------------------------------------------------------------------------

def _z_zero_ring(xs, ys, zs, label, cfg: types.SimpleNamespace) -> None:
    n = xs.shape[0]
    cp = int(cfg.curb_points)
    if n - 2 * cp < 1:
        return
    j = np.arange(cp, n - cp)
    d = np.sqrt((xs[j + cp] - xs[j - cp]).astype(F64) ** 2
                + (ys[j + cp] - ys[j - cp]).astype(F64) ** 2).astype(F32)
    # Windowed sums of (p_k - p_j): sum_{k=j-cp}^{j-1} x_k  - cp*x_j etc.
    # (float64 accumulation, rounded once — documented divergence.)
    cx = np.concatenate(([0.0], np.cumsum(xs.astype(F64))))
    cy = np.concatenate(([0.0], np.cumsum(ys.astype(F64))))
    va1 = (cx[j] - cx[j - cp] - cp * xs[j].astype(F64)).astype(F32)
    va2 = (cy[j] - cy[j - cp] - cp * ys[j].astype(F64)).astype(F32)
    vb1 = (cx[j + cp + 1] - cx[j + 1] - cp * xs[j].astype(F64)).astype(F32)
    vb2 = (cy[j + cp + 1] - cy[j + 1] - cp * ys[j].astype(F64)).astype(F32)
    inv_cp = F32(1) / F32(cp)
    va1, va2, vb1, vb2 = va1 * inv_cp, va2 * inv_cp, vb1 * inv_cp, vb2 * inv_cp
    # Windowed max of |z| over [j-cp, j] and [j, j+cp] (includes j via init).
    absz = np.abs(zs)
    max1 = absz[j].copy()
    max2 = absz[j].copy()
    for k in range(1, cp + 1):
        np.maximum(max1, absz[j - k], out=max1)
        np.maximum(max2, absz[j + k], out=max2)
    with np.errstate(invalid="ignore", divide="ignore"):
        bracket = (
            (va1 * vb1 + va2 * vb2).astype(F64)
            / (np.sqrt(va1.astype(F64) ** 2 + va2.astype(F64) ** 2)
               * np.sqrt(vb1.astype(F64) ** 2 + vb2.astype(F64) ** 2))
        ).astype(F32)
    bracket = np.clip(bracket, F32(-1), F32(1))
    alpha = np.degrees(np.arccos(bracket.astype(F64))).astype(F32)
    cond = (
        (d < 5.0)
        & (alpha <= F32(cfg.cylinder_deg_z))
        & ((max1 - absz[j] >= F32(cfg.curb_height)) | (max2 - absz[j] >= F32(cfg.curb_height)))
        & (np.abs(max1 - max2).astype(F64) >= 0.05)
    )
    label[j[cond]] = LABEL_CURB


# --------------------------------------------------------------------------
# Stage L4: blind spots + road flood fill (blind_spots.cpp:7-284)
# --------------------------------------------------------------------------

def _quadrant_extremes(alpha1: np.ndarray, label1: np.ndarray):
    """Extremal curb azimuths on arc #1 per quadrant (blind_spots.cpp:19-57)."""
    q1, q2, q3, q4 = F32(0), F32(180), F32(180), F32(360)
    curb = label1 == LABEL_CURB
    a = alpha1[curb]
    m = a[(a >= 0) & (a < 90)]
    if m.size and m.max() > q1:
        q1 = m.max()
    m = a[(a >= 90) & (a < 180)]
    if m.size and m.min() < q2:
        q2 = m.min()
    m = a[(a >= 180) & (a < 270)]
    if m.size and m.max() > q3:
        q3 = m.max()
    # "else" bucket: everything failing the first three range tests
    # (i.e. alpha >= 270, alpha < 0, or NaN; NaN never updates q4 since
    # `alpha < q4` is false for NaN, as in the C++).
    m = a[~(((a >= 0) & (a < 90)) | ((a >= 90) & (a < 180)) | ((a >= 180) & (a < 270)))]
    m = m[~np.isnan(m)]
    if m.size and m.min() < q4:
        q4 = m.min()
    return q1, q2, q3, q4


def _blind_gate(i: F32, q, x_direction: int) -> bool:
    """Blind-spot angular gate (blind_spots.cpp:77-99), float32 compares."""
    q1, q2, q3, q4 = q
    if x_direction == 0:
        return bool((q1 != 0 and q4 != 360 and (i <= q1 or i >= q4))
                    or (q2 != 180 and q3 != 180 and q2 <= i <= q3))
    if x_direction == 1:
        return bool((q2 != 180 and q2 <= i <= 270) or (q1 != 0 and (i <= q1 or i >= 270)))
    return bool((q4 != 360 and (i >= q4 or i <= 90)) or (q3 != 180 and 90 <= i <= q3))


def _blind_spots(ring_alpha: list, ring_label: list, num_rings: int,
                 max_distance: np.ndarray, cfg: types.SimpleNamespace) -> None:
    """Both angular sweeps.  ring_alpha[k] must be sorted ascending; labels
    are modified in place.  Only reads curb labels (2) and writes road (1),
    so per-start work is order independent (see SURVEY.md section 7)."""
    bz = F32(cfg.beam_zone)
    q = (F32(0), F32(180), F32(180), F32(360))
    if cfg.blind_spots and num_rings > 1:
        q = _quadrant_extremes(ring_alpha[1], ring_label[1])

    # arcDistance (blind_spots.cpp:65): f32((maxDist0 * pi / 180) * beamZone)
    arc_distance = F32((F64(max_distance[0]) * math.pi / 180.0) * F64(bz))

    def seg(k: int, lo: F32, hi: F32):
        a = ring_alpha[k]
        return np.searchsorted(a, lo, "left"), np.searchsorted(a, hi, "right")

    def curb_in(k: int, l: int, r: int) -> bool:
        return bool(np.any(ring_label[k][l:r] == LABEL_CURB))

    hi_bound = F32(360) - bz  # `360 - params::beamZone` (int - float, f32)

    # ---- forward sweep: 0 .. 360-beamZone (blind_spots.cpp:68-174) ----
    i = 0
    while F32(i) <= hi_bound:
        fi_ = F32(i)
        if not (cfg.blind_spots and _blind_gate(fi_, q, cfg.x_direction)):
            l0, r0 = seg(0, fi_, F32(fi_ + bz))
            if not curb_in(0, l0, r0):
                ring_label[0][l0:r0] = LABEL_ROAD
                for k in range(1, num_rings):
                    if fi_ == hi_bound:
                        cd = F32(360)
                    else:
                        with np.errstate(divide="ignore"):
                            cd = F32(F64(i) + F64(arc_distance)
                                     / (F64(max_distance[k]) * math.pi / 180.0))
                    lk, rk = seg(k, fi_, cd)
                    if curb_in(k, lk, rk):
                        break
                    ring_label[k][lk:rk] = LABEL_ROAD
        i += 1

    # ---- backward sweep: 360 .. beamZone (blind_spots.cpp:177-283) ----
    i = 360
    while F32(i) >= bz:
        fi_ = F32(i)
        if not (cfg.blind_spots and _blind_gate(fi_, q, cfg.x_direction)):
            l0, r0 = seg(0, F32(fi_ - bz), fi_)
            if not curb_in(0, l0, r0):
                ring_label[0][l0:r0] = LABEL_ROAD
                for k in range(1, num_rings):
                    if fi_ == bz:
                        cd = F32(0)
                    else:
                        with np.errstate(divide="ignore"):
                            cd = F32(F64(i) - F64(arc_distance)
                                     / (F64(max_distance[k]) * math.pi / 180.0))
                    lk, rk = seg(k, cd, fi_)
                    if curb_in(k, lk, rk):
                        break
                    ring_label[k][lk:rk] = LABEL_ROAD
        i -= 1


# --------------------------------------------------------------------------
# Stage L5: marker-point search (lidar_segmentation.cpp:295-351)
# --------------------------------------------------------------------------

def _marker_search(ring_x, ring_y, ring_z, ring_alpha, ring_label, num_rings):
    """Farthest road point per 1-degree bin, stopping at the first non-road
    point in (arc-major, azimuth-minor) scan order."""
    rows, bins = [], []
    # Flatten with scan-order keys.
    xs, ys, zs, al, lb, g = [], [], [], [], [], []
    big = 1 + max((a.shape[0] for a in ring_alpha[:num_rings]), default=0)
    for k in range(num_rings):
        n = ring_alpha[k].shape[0]
        if n == 0:
            continue
        xs.append(ring_x[k]); ys.append(ring_y[k]); zs.append(ring_z[k])
        al.append(ring_alpha[k]); lb.append(ring_label[k])
        g.append(k * big + np.arange(n))
    if not xs:
        return (np.zeros((0, 4), F32), np.zeros((0,), np.int32))
    xs = np.concatenate(xs); ys = np.concatenate(ys); zs = np.concatenate(zs)
    al = np.concatenate(al); lb = np.concatenate(lb); g = np.concatenate(g)

    ok = ~np.isnan(al)
    bin_of = np.full(al.shape, -1, np.int64)
    bin_of[ok] = np.floor(al[ok]).astype(np.int64)
    d = np.sqrt((F32(0) - xs).astype(F64) ** 2 + (F32(0) - ys).astype(F64) ** 2).astype(F32)

    for b in range(0, 361):
        in_bin = bin_of == b
        if not np.any(in_bin):
            continue
        nonroad = in_bin & (lb != LABEL_ROAD)
        f = g[nonroad].min() if np.any(nonroad) else np.iinfo(np.int64).max
        cand = in_bin & (lb == LABEL_ROAD) & (g < f) & (d > 0)
        if not np.any(cand):
            continue
        dc = d[cand]
        gc = g[cand]
        maxd = dc.max()
        winner_g = gc[dc == maxd].min()  # first-in-scan-order among ties
        w = np.flatnonzero(cand & (g == winner_g))[0]
        rows.append((xs[w], ys[w], zs[w], F32(1) if f != np.iinfo(np.int64).max else F32(0)))
        bins.append(b)
    return (np.asarray(rows, F32).reshape(-1, 4), np.asarray(bins, np.int32))


# --------------------------------------------------------------------------
# Full pipeline
# --------------------------------------------------------------------------

def run_oracle(points: np.ndarray, cfg,
               edge_nudge: float = 0.0,
               channels: int = CHANNELS) -> OracleResult:
    """Run the full reference pipeline on one scan.

    points: (N, >=3) float array of x, y, z (column 3+, e.g. intensity,
    is carried along but never used by the algorithms, matching PointXYZI).

    edge_nudge: relative scale (e.g. +-4e-7, a few f32 ulp) applied to
    every azimuth value right before it is compared against a 1-degree
    quantization edge (star beam binning, marker bins, flood-fill window
    arithmetic).  Used by parity gates to build the oracle's own
    *sensitivity envelope*: a device flip reproduced by a +-few-ulp edge
    nudge — including its flood-fill cascade — is boundary-class, not a
    systematic divergence.  0.0 (default) is the exact reference
    semantics.
    """
    points = np.asarray(points, dtype=F32)
    keep = roi_mask(points, cfg)
    pts = points[keep]
    piece = pts.shape[0]
    empty = lambda *s: np.zeros(s, F32)
    if piece < MIN_POINTS:
        return OracleResult(
            ok=False, roi_mask=keep, labels=np.zeros(piece, np.int16),
            ring_of_point=np.full(piece, -1, np.int32), ring_angles=empty(0),
            num_rings=0, max_distance=empty(channels), ring_point_ids=[],
            ring_alpha=[], marker_points=empty(0, 4),
            marker_bins=np.zeros(0, np.int32), road_ids=np.zeros(0, np.int64),
            curb_ids=np.zeros(0, np.int64), probably_road_ids=np.zeros(0, np.int64))

    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    _, alpha_v = vertical_angles(x, y, z)
    reps = discover_rings(alpha_v, cfg.interval, channels=channels)

    labels2d = np.zeros(piece, np.int16)
    if cfg.star_shaped_method:
        star_shaped_search(x, y, z, labels2d, cfg, edge_nudge=edge_nudge)

    # Ring binning (lidar_segmentation.cpp:205-278): first match in
    # ascending-angle order; unmatched points dropped.
    angles = np.sort(reps)
    index = angles.shape[0]
    match = np.abs(angles[None, :] - alpha_v[:, None]) <= F32(cfg.interval)
    has = match.any(axis=1)
    ring_of_point = np.where(has, match.argmax(axis=1), -1).astype(np.int32)

    d2, alpha_a = azimuth_2d(x, y)
    if edge_nudge:
        # Envelope mode: perturb the azimuth a few ulp before the degree-
        # quantized stages (flood windows, marker bins) read it.  Positive
        # scale preserves per-ring sort order.
        alpha_a = (alpha_a * F32(1.0 + edge_nudge)).astype(F32)

    ring_x, ring_y, ring_z, ring_a, ring_l, ring_ids = [], [], [], [], [], []
    max_distance = np.zeros(channels, F32)
    for k in range(index):
        ids = np.flatnonzero(ring_of_point == k)  # input order
        ring_ids.append(ids)
        ring_x.append(x[ids].astype(F32).copy())
        ring_y.append(y[ids].astype(F32).copy())
        ring_z.append(z[ids].astype(F32).copy())
        ring_a.append(alpha_a[ids].copy())
        ring_l.append(labels2d[ids].copy() if cfg.star_shaped_method
                      else np.zeros(ids.size, np.int16))
        if ids.size:
            max_distance[k] = d2[ids].max()

    if cfg.x_zero_method:
        for k in range(index):
            _x_zero_ring(ring_x[k], ring_y[k], ring_z[k], ring_l[k], cfg)
    if cfg.z_zero_method:
        for k in range(index):
            _z_zero_ring(ring_x[k], ring_y[k], ring_z[k], ring_l[k], cfg)

    # Per-ring azimuth sort (lidar_segmentation.cpp:289-291); stable here.
    for k in range(index):
        srt = np.argsort(ring_a[k], kind="stable")
        for arr in (ring_x, ring_y, ring_z, ring_a, ring_l, ring_ids):
            arr[k] = arr[k][srt]

    _blind_spots(ring_a, ring_l, index, max_distance, cfg)

    marker_points, marker_bins = _marker_search(
        ring_x, ring_y, ring_z, ring_a, ring_l, index)

    # Scatter labels back to ROI-point input order.
    labels = np.zeros(piece, np.int16)
    for k in range(index):
        labels[ring_ids[k]] = ring_l[k]

    # Output clouds in the reference's publish order (ring-major, sorted).
    road_ids, curb_ids = [], []
    for k in range(index):
        road_ids.append(ring_ids[k][ring_l[k] == LABEL_ROAD])
        curb_ids.append(ring_ids[k][ring_l[k] == LABEL_CURB])
    road_ids = np.concatenate(road_ids) if road_ids else np.zeros(0, np.int64)
    curb_ids = np.concatenate(curb_ids) if curb_ids else np.zeros(0, np.int64)
    prr = int(getattr(cfg, "probably_road_ring", PROBABLY_ROAD_RING))
    probably = (ring_ids[prr] if index > prr else np.zeros(0, np.int64))

    return OracleResult(
        ok=True, roi_mask=keep, labels=labels, ring_of_point=ring_of_point,
        ring_angles=angles, num_rings=index, max_distance=max_distance,
        ring_point_ids=ring_ids, ring_alpha=ring_a,
        marker_points=marker_points, marker_bins=marker_bins,
        road_ids=road_ids, curb_ids=curb_ids, probably_road_ids=probably)
