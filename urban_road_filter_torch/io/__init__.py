"""Scan sources: the emulated scans and scenes (synthetic.py), the
multi-LiDAR merge (multi_lidar.py), recorded scans as PCD files and NPZ
sequences (pcd.py) and rosbags (rosbag.py), numpy code the port carries as
its own copy of the JAX package's io modules; and the port's streaming
harness (replay.py)."""

from urban_road_filter_torch.io.multi_lidar import Extrinsics, merge_scans
from urban_road_filter_torch.io.synthetic import (
    SCENES, SceneSpec, make_drive, make_scan, make_sensor_scan, random_scan)

__all__ = ["SCENES", "Extrinsics", "SceneSpec", "make_drive", "make_scan",
           "make_sensor_scan", "merge_scans", "random_scan", "read_bag",
           "write_bag", "bag_topics"]


def __getattr__(name):
    # Lazy, as in the JAX package: rosbag pulls bz2/struct only when used.
    if name in ("read_bag", "write_bag", "bag_topics"):
        from urban_road_filter_torch.io import rosbag

        return getattr(rosbag, name)
    raise AttributeError(name)
