"""Scan sources: the emulated scans and scenes (synthetic.py) and the
multi-LiDAR merge (multi_lidar.py), numpy code the port carries as its own
copy of the JAX package's io modules."""

from urban_road_filter_torch.io.multi_lidar import Extrinsics, merge_scans
from urban_road_filter_torch.io.synthetic import (
    SCENES, SceneSpec, make_drive, make_scan, make_sensor_scan, random_scan)

__all__ = ["SCENES", "Extrinsics", "SceneSpec", "make_drive", "make_scan",
           "make_sensor_scan", "merge_scans", "random_scan"]
