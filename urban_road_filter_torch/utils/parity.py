"""Parity-classification helpers shared by the test suite and bench gate.

A device-vs-oracle disagreement is LEGITIMATE (boundary-ulp class) only
when a <=1-ulp numeric difference can explain it; everything else is a
systematic divergence and must fail the gate (VERDICT r2 item 8 for
markers, r3 item 2 for labels).  The classifiers here are pure NumPy.
The port's own copy of urban_road_filter_tpu/utils/parity.py, behaviour
kept; the gate reads compact_markers from the port's ops/markers.py.
"""

from __future__ import annotations

import math

import numpy as np


def nudged_config(pcfg, s: float):
    """The per-point comparison thresholds (x/z-zero cosine gates, star
    slope + adaptive scale, curb height) scaled by (1 + s): a device flip
    explainable by a +-s relative nudge of these is ulp-class, not
    systematic.

    `interval` is nudged too: the ring-match test |alpha - rep| <=
    interval is exactly where a 1-2 ulp vertical-angle (arcsin tail)
    difference between two compiled graphs re-keys a point to an adjacent
    ring (PARITY item 13's near-threshold regime; alpha's ulp at ~90 deg
    is ~7.6e-6, so interval * 1e-4 ~= 1.8e-5 covers ~2 ulp).  A uniform
    nudge of alpha itself cannot model this (alpha and its rep share a
    binade, so their DIFFERENCE is ulp-invariant) — moving the matching
    boundary is the faithful envelope.  In the >64-ring mixed-table
    regime a re-keyed point lands in a different z-zero window and its
    flip cascades; the envelope runs reproduce that cascade."""
    f = 1.0 + s
    return pcfg.replace(
        cylinder_deg_x=pcfg.cylinder_deg_x * f,
        cylinder_deg_z=pcfg.cylinder_deg_z * f,
        curb_slope_deg=pcfg.curb_slope_deg * f,
        curb_height=pcfg.curb_height * f,
        kdev_param=pcfg.kdev_param * f,
        kdist_param=pcfg.kdist_param * f,
        interval=pcfg.interval * f)


def device_parity_gate(raw_scan: np.ndarray, labels, markers, pcfg,
                       name: str, eps: float = 1e-4,
                       channels: int | None = None):
    """Classify a device run against the oracle (VERDICT r3 item 2).

    Returns (label_agreement, n_systematic_flips).  Every label flip must
    be boundary-class: the point's azimuth within ~ulp of an integer
    1-degree bin edge, OR inside the oracle's own sensitivity ENVELOPE —
    two oracle re-runs with the thresholds nudged +-eps relative and the
    degree-quantization edges nudged a few f32 ulp; a flip any of the
    three runs disagree on (including its flood-fill cascade) is
    ulp-class.  Device marker rows are gated the same way: a differing
    row must be a near-tie/bin-edge winner (marker_rows_boundary_ok) or
    sit in a bin the envelope marks unstable (e.g. a NON-road gating
    point a ulp from a bin edge moves the scan-order gate f of adjacent
    bins — observed at the 89/90-degree edge on device).  Raises
    AssertionError on any marker row outside both classes; systematic
    label flips are returned for the caller to gate on.

    ``channels``: oracle ring cap override for >64-ring deployments (the
    reference's compile-time `channels = 64`, lidar_segmentation.cpp:4,
    rebuilt higher for e.g. the 128-ring multi-LiDAR rig); None keeps the
    reference default.
    """
    from urban_road_filter_torch.oracle import run_oracle as _run
    from urban_road_filter_torch.oracle.reference import azimuth_2d
    from urban_road_filter_torch.ops.markers import compact_markers

    if channels is None:
        run_oracle = _run
    else:
        run_oracle = lambda pts, c, **kw: _run(pts, c, channels=channels,
                                               **kw)

    orc = run_oracle(raw_scan, pcfg)
    if not orc.labels.size:
        return 1.0, 0
    got = np.asarray(labels)[:len(raw_scan)][orc.roi_mask]
    flips = got != orc.labels
    agree = float(1.0 - np.mean(flips))
    rows, bins = compact_markers(np.asarray(markers))
    bins_match = (len(bins) == len(orc.marker_bins)
                  and np.array_equal(bins, orc.marker_bins))

    envelope = []

    def _envelope():
        if not envelope:
            envelope.append(run_oracle(raw_scan, nudged_config(pcfg, -eps),
                                       edge_nudge=-4e-7))
            envelope.append(run_oracle(raw_scan, nudged_config(pcfg, +eps),
                                       edge_nudge=+4e-7))
        return envelope

    n_sys = 0
    if flips.any():
        lo, hi = _envelope()
        env = ((lo.labels != hi.labels) | (lo.labels != orc.labels)
               | (hi.labels != orc.labels))
        idx = np.nonzero(flips)[0]
        rpts = raw_scan[orc.roi_mask]
        _, aa = azimuth_2d(rpts[idx, 0].astype(np.float32),
                           rpts[idx, 1].astype(np.float32))
        aa = np.where(np.isnan(aa), 0.5, aa)
        near_bin = np.abs(aa - np.round(aa)) <= 1e-4
        n_sys = int(np.sum(~near_bin & ~env[idx]))

    def _bin_rows(res):
        return {int(b): res.marker_points[i, :3]
                for i, b in enumerate(res.marker_bins)}

    def _unstable_bins():
        lo, hi = _envelope()
        views = [_bin_rows(r) for r in (orc, lo, hi)]
        keys = set().union(*views)
        bad_bins = set()
        for b in keys:
            have = [v.get(b) for v in views]
            if any(h is None for h in have) or any(
                    not np.allclose(have[0], h, atol=1e-4)
                    for h in have[1:]):
                bad_bins.add(b)
        return bad_bins

    if bins_match:
        diff = ~np.all(np.abs(rows[:, :3] - orc.marker_points[:, :3])
                       < 1e-4, axis=1)
        if diff.any():
            bad = diff & ~marker_rows_boundary_ok(
                rows[:, :3], orc.marker_points[:, :3])
            if bad.any():
                unstable = _unstable_bins()
                left = [int(bins[i]) for i in np.nonzero(bad)[0]
                        if int(bins[i]) not in unstable]
                assert not left, (
                    f"{name}: non-boundary marker rows outside the "
                    f"envelope, bins {left[:8]}")
    else:
        # Bin-set drift must itself be envelope-explained.
        moved = set(np.asarray(bins).tolist()) ^ set(
            orc.marker_bins.tolist())
        left = moved - _unstable_bins()
        assert not left, (
            f"{name}: marker bins moved outside envelope: "
            f"{sorted(left)[:8]}")
    return agree, n_sys


def marker_rows_boundary_ok(got3: np.ndarray, want3: np.ndarray) -> np.ndarray:
    """Per-row bool: a disagreeing marker row is LEGITIMATE only when a
    <=1-ulp numeric difference can flip the per-bin argmax — the two
    winners are a near-tie in distance, or a winner's azimuth sits within
    ~2 ulp of an integer 1-degree bin edge (reference bin semantics:
    lidar_segmentation.cpp:305-351)."""

    def azimuth(x, y):
        d2 = np.hypot(np.float64(x), np.float64(y))
        if d2 == 0:
            return 0.0
        b = float(np.clip(np.abs(x) / d2, -1, 1))
        a = math.degrees(math.asin(b))
        if x >= 0 and y <= 0:
            return a
        if x >= 0:
            return 180 - a
        if x < 0 and y >= 0:
            return 180 + a
        return 360 - a

    ok = np.zeros(len(got3), bool)
    for k in range(len(got3)):
        dj = np.hypot(got3[k, 0], got3[k, 1])
        do = np.hypot(want3[k, 0], want3[k, 1])
        near_tie = abs(dj - do) <= 4e-7 * max(dj, do, 1.0)
        edge = any(
            abs(azimuth(r[0], r[1]) - round(azimuth(r[0], r[1]))) <= 1e-4
            for r in (got3[k], want3[k]))
        ok[k] = near_tie or edge
    return ok
