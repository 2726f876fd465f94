"""Scan sources.  The emulated scans are the reference package's numpy
generators (urban_road_filter_tpu/io/synthetic.py, which imports no JAX),
reused rather than copied."""

from urban_road_filter_tpu.io.synthetic import (
    SCENES, make_drive, make_scan, make_sensor_scan, random_scan)

__all__ = ["SCENES", "make_drive", "make_scan", "make_sensor_scan",
           "random_scan"]
