"""Multi-LiDAR scan merging (BASELINE.json config #5: multi-sensor rig).

The reference's demo rig carries 2x Ouster OS1-64 + 2x Velodyne
(config/demo1.rviz:91-181) but the node consumes a single topic; fusing
sensors happens upstream.  This module provides that upstream step: rigid
per-sensor extrinsics applied on host (cheap, NumPy) or as a batched device
op, concatenating the returns into one padded cloud for the pipeline.

Note ring discovery operates on vertical angle w.r.t. the PIPELINE origin:
merged sensors at different heights interleave rings exactly as they would
for the reference fed a pre-merged cloud.

The port's own copy of urban_road_filter_tpu/io/multi_lidar.py, behaviour kept.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

__all__ = ["Extrinsics", "merge_scans"]


@dataclasses.dataclass(frozen=True)
class Extrinsics:
    """Rigid sensor-to-vehicle transform: yaw/pitch/roll (deg) then
    translation (m)."""

    x: float = 0.0
    y: float = 0.0
    z: float = 0.0
    yaw_deg: float = 0.0
    pitch_deg: float = 0.0
    roll_deg: float = 0.0

    def matrix(self) -> np.ndarray:
        cy, sy = math.cos(math.radians(self.yaw_deg)), math.sin(math.radians(self.yaw_deg))
        cp, sp = math.cos(math.radians(self.pitch_deg)), math.sin(math.radians(self.pitch_deg))
        cr, sr = math.cos(math.radians(self.roll_deg)), math.sin(math.radians(self.roll_deg))
        rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
        ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
        rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
        return (rz @ ry @ rx).astype(np.float64)


def merge_scans(scans: Sequence[np.ndarray],
                extrinsics: Sequence[Extrinsics]) -> np.ndarray:
    """Transform each sensor's (Ni, >=3) scan into the vehicle frame and
    concatenate.  Missing returns (0,0,0) stay (0,0,0) — they must keep
    failing the reference's x+y+z != 0 drop rather than becoming phantom
    points at the sensor origin."""
    if len(scans) != len(extrinsics):
        raise ValueError("one Extrinsics per scan required")
    out = []
    for pts, ext in zip(scans, extrinsics):
        pts = np.asarray(pts, np.float32)
        xyz = pts[:, :3].astype(np.float64)
        miss = ~np.any(xyz != 0.0, axis=1)
        t = np.array([ext.x, ext.y, ext.z])
        moved = (xyz @ ext.matrix().T + t).astype(np.float32)
        moved[miss] = 0.0
        rest = pts[:, 3:4] if pts.shape[1] > 3 else np.zeros((len(pts), 1), np.float32)
        out.append(np.concatenate([moved, rest], axis=1))
    return np.concatenate(out, axis=0)
