"""Scan sources.  The emulated scans and the multi-LiDAR merge are the
reference package's numpy code (urban_road_filter_tpu/io/synthetic.py and
io/multi_lidar.py, which import no JAX), reused rather than copied."""

from urban_road_filter_tpu.io.multi_lidar import Extrinsics, merge_scans
from urban_road_filter_tpu.io.synthetic import (
    SCENES, SceneSpec, make_drive, make_scan, make_sensor_scan, random_scan)

__all__ = ["SCENES", "Extrinsics", "SceneSpec", "make_drive", "make_scan",
           "make_sensor_scan", "merge_scans", "random_scan"]
