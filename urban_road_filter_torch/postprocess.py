"""Host-side marker assembly: run smoothing, line strips, Ramer-Douglas-
Peucker simplification and ghost-marker cleanup.

Re-implements the reference's L5 marker pipeline
(lidar_segmentation.cpp:369-602) on the tiny (<=361-row) marker table that
the device produces, replacing ROS visualization_msgs with plain dicts.
The inputs are small enough that this is deliberately host code — the same
stance the reference takes by leaning on boost::geometry for RDP.

A copy of the JAX package's postprocess.py (numpy only), which the port
carries so that it imports nothing of that package
(tests/test_torch_io.py holds it to the original).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

__all__ = ["smooth_marker_flags", "rdp", "build_line_strips", "MarkerTracker"]

GREEN, RED = 0.0, 1.0


def smooth_marker_flags(flags: np.ndarray) -> np.ndarray:
    """Red/green run smoothing (lidar_segmentation.cpp:381-415).

    Sequential semantics preserved: endpoint pairing first (4 ordered ifs),
    then the green-between-reds pass, then the red-between-greens pass —
    each pass sees the previous pass's writes.
    """
    f = flags.astype(np.float32).copy()
    n = f.shape[0]
    if n <= 2:
        return f
    if f[0] == 0 and f[1] == 1:
        f[0] = 1
    if f[n - 1] == 0 and f[n - 2] == 1:
        f[n - 1] = 1
    if f[0] == 1 and f[1] == 0:
        f[0] = 0
    if f[n - 1] == 1 and f[n - 2] == 0:
        f[n - 1] = 0
    for i in range(2, n - 2):
        if f[i] == 0 and f[i - 1] == 1 and f[i + 1] == 1:
            f[i] = 1
    for i in range(2, n - 2):
        if f[i] == 1 and f[i - 1] == 0 and f[i + 1] == 0:
            f[i] = 0
    return f


def rdp(points: np.ndarray, eps: float) -> np.ndarray:
    """Ramer-Douglas-Peucker on an (n, 2) polyline, point-to-SEGMENT
    distance (the boost::geometry::simplify default douglas_peucker strategy
    uses projected_point, which clamps the projection to the segment and
    falls back to endpoint distance — lidar_segmentation.cpp:475; ADVICE r1:
    infinite-line distance diverges on polylines that double back past a
    segment end)."""
    pts = np.asarray(points, dtype=np.float64)
    n = pts.shape[0]
    if n < 3:
        return pts.copy()
    keep = np.zeros(n, dtype=bool)
    keep[0] = keep[-1] = True
    stack = [(0, n - 1)]
    while stack:
        a, b = stack.pop()
        if b - a < 2:
            continue
        seg = pts[b] - pts[a]
        l2 = float(seg @ seg)
        mid = pts[a + 1:b] - pts[a]
        if l2 == 0.0:
            dist = np.hypot(mid[:, 0], mid[:, 1])
        else:
            t = np.clip((mid @ seg) / l2, 0.0, 1.0)
            diff = mid - t[:, None] * seg
            dist = np.hypot(diff[:, 0], diff[:, 1])
        imax = int(np.argmax(dist))
        if dist[imax] > eps:
            k = a + 1 + imax
            keep[k] = True
            stack.append((a, k))
            stack.append((k, b))
    return pts[keep]


@dataclasses.dataclass
class LineStrip:
    id: int
    color: str  # "green" (road-bounded) or "red" (obstacle-bounded)
    points: np.ndarray  # (n, 3) float32
    action: str = "add"  # "add" | "delete"


def build_line_strips(
    marker_points: np.ndarray,
    polysimp_allow: bool = True,
    polysimp: float = 0.7,
    polyz: float = -1.5,
    zavg_allow: bool = True,
) -> tuple:
    """Line-strip assembly (lidar_segmentation.cpp:417-589).

    marker_points: (cM, 4) [x, y, z, flag]; flags must already be smoothed.
    Requires cM > 2, like the reference (cpp:371).

    Returns (strips, line_strip_id): line_strip_id is the C++ `lineStripID`
    counter's final value — when the sequence ends on a color transition
    (possible only for UN-smoothed flags) it is one past the last pushed
    strip's id, and MarkerTracker needs exactly that value to reproduce the
    reference's ghost-DELETE id range.
    """
    m = np.asarray(marker_points, dtype=np.float32)
    cm = m.shape[0]
    if cm <= 2:
        return [], 0
    flags = m[:, 3]

    # zavg: running mean of ALL marker z, float32 (cpp:436-438).
    zavg = np.float32(0)
    for i in range(cm):
        zavg = zavg * np.float32(i)
        zavg = zavg + m[i, 2]
        zavg = zavg / np.float32(i + 1)

    strips: List[LineStrip] = []
    cur: list = [m[0, :3]]
    strip_id = 0

    def emit(color_flag: float, pts_list: list) -> None:
        nonlocal strip_id
        pts = np.asarray(pts_list, dtype=np.float32).reshape(-1, 3)
        if polysimp_allow:
            simp = rdp(pts[:, :2], polysimp)
            pts = np.concatenate(
                [simp.astype(np.float32),
                 np.full((simp.shape[0], 1), np.float32(polyz))], axis=1)
        strips.append(LineStrip(
            id=strip_id, color="green" if color_flag == GREEN else "red", points=pts))

    for i in range(1, cm):
        p = m[i, :3]
        if flags[i] == flags[i - 1]:
            cur.append(p)
            if i == cm - 1:
                emit(flags[i], cur)  # final strip keeps id == strip_id (cpp:456-490)
        elif flags[i] == GREEN:  # red -> green: point closes the red strip (cpp:495-529)
            cur.append(p)
            emit(RED, cur)
            strip_id += 1
            cur = [p]
        else:  # green -> red: emit green w/o this point, red starts at prev (cpp:534-577)
            emit(GREEN, cur)
            strip_id += 1
            cur = [m[i - 1, :3], p]

    if zavg_allow:
        for s in strips:
            s.points = s.points.copy()
            s.points[:, 2] = zavg
    return strips, strip_id


class MarkerTracker:
    """Cross-scan ghost-marker removal (lidar_segmentation.cpp:23,591-598).

    The only cross-scan state in the reference.  The C++ loop pushes
    `ghostcount - lineStripID` DELETE markers with ids counting up from the
    last PUSHED strip's id + 1, then sets ghostcount = lineStripID.
    """

    def __init__(self) -> None:
        self.ghostcount = 0

    def finalize(self, strips: List[LineStrip],
                 line_strip_id: int | None = None) -> List[LineStrip]:
        if not strips:
            return strips
        last_pushed = strips[-1].id
        if line_strip_id is None:
            line_strip_id = last_pushed
        out = list(strips)
        n_del = max(0, self.ghostcount - line_strip_id)
        for k in range(n_del):
            out.append(LineStrip(id=last_pushed + 1 + k, color="red",
                                 points=np.zeros((0, 3), np.float32),
                                 action="delete"))
        self.ghostcount = line_strip_id
        return out
