"""Scan-invariant constants of the pipeline.

The reference precomputes per-beam trigonometry once at node construction
(``Detector::beam_init``, star_shaped_search.cpp:32-66).  Here the same
tables are module-level NumPy constants that get baked into the compiled
XLA program as literals.

The port's own copy of urban_road_filter_tpu/constants.py, behaviour kept.
"""

from __future__ import annotations

import math

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
