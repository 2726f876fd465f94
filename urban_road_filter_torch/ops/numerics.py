"""Float32 rules shared by the stages: host thresholds rounded to float32,
the correctly rounded square root, and the ROI compare chain.  A leaf
module: geometry.py and ingest.py both import it."""

from __future__ import annotations

import numpy as np
import torch

from urban_road_filter_torch.config import FilterConfig

F32 = torch.float32
I32 = torch.int32


def f32(v) -> float:
    """A host scalar rounded to float32, as a Python float (exact)."""
    return float(np.float32(v))


def sqrt_rn(v: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root, as XLA and CUDA's sqrtf give it.
    torch's vectorized CPU sqrt is not (it is off by an ulp on ~0.5 % of
    inputs); the float64 root rounded once to float32 is, on every device."""
    return torch.sqrt(v.double()).float()


def roi_mask_xyz(x, y, z, cfg: FilterConfig) -> torch.Tensor:
    """Crop box + zero-point drop (lidar_segmentation.cpp:106-117)."""
    return ((x >= f32(cfg.min_x)) & (x <= f32(cfg.max_x))
            & (y >= f32(cfg.min_y)) & (y <= f32(cfg.max_y))
            & (z >= f32(cfg.min_z)) & (z <= f32(cfg.max_z))
            & (x + y + z != 0.0))
