"""Float32 rules shared by the stages: host thresholds rounded to float32,
dynamic parameters as the stages read them, the correctly rounded square
root, and the ROI compare chain.  A leaf module: geometry.py and ingest.py
both import it."""

from __future__ import annotations

import numpy as np
import torch

from urban_road_filter_torch.config import FilterConfig

F32 = torch.float32
I32 = torch.int32


def f32(v) -> float:
    """A host scalar rounded to float32, as a Python float (exact)."""
    return float(np.float32(v))


def param(v):
    """A dynamic parameter as the plain twins use it: a tensor (a 0-d view
    of the device parameter buffer, config.device_config) as it is, a host
    scalar rounded to float32 (f32).  Either gives the same bits in every
    compare and float32 operation the twins make with it."""
    return v if isinstance(v, torch.Tensor) else f32(v)


_scalars: dict = {}  # (device, dtype, value's bits) -> its 0-d tensor
_SCALARS_KEPT = 1024


def param_tensor(v, device, dtype=F32) -> torch.Tensor:
    """A dynamic parameter as a kernel reads it: one value in device memory
    on ``device``.  A 0-d tensor there of ``dtype`` is used as it is (a
    view of the parameter buffer); a host scalar becomes a 0-d tensor made
    by a fill (no host-to-device copy) on the current stream the first
    time, and kept, for direct calls."""
    if isinstance(v, torch.Tensor):
        if v.device != device or v.dtype != dtype or v.ndim != 0:
            raise ValueError(f"a parameter must be a 0-d {dtype} tensor on "
                             f"{device}, got {v.dtype} {tuple(v.shape)} on "
                             f"{v.device}")
        return v
    val = f32(v) if dtype == F32 else int(v)
    key = (device, dtype, np.float32(val).tobytes() if dtype == F32
           else val)
    hit = _scalars.get(key)
    if hit is None:
        if len(_scalars) >= _SCALARS_KEPT:
            _scalars.clear()
        hit = _scalars[key] = torch.full((), val, dtype=dtype, device=device)
    return hit


def sqrt_rn(v: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root, as XLA and CUDA's sqrtf give it.
    torch's vectorized CPU sqrt is not (it is off by an ulp on ~0.5 % of
    inputs); the float64 root rounded once to float32 is, on every device."""
    return torch.sqrt(v.double()).float()


def roi_mask_xyz(x, y, z, cfg: FilterConfig) -> torch.Tensor:
    """Crop box + zero-point drop (lidar_segmentation.cpp:106-117)."""
    return ((x >= param(cfg.min_x)) & (x <= param(cfg.max_x))
            & (y >= param(cfg.min_y)) & (y <= param(cfg.max_y))
            & (z >= param(cfg.min_z)) & (z <= param(cfg.max_z))
            & (x + y + z != 0.0))
