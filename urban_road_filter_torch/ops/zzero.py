"""z-zero curb detection (reference: z_zero_method.cpp:5-76), plain PyTorch.

Port of urban_road_filter_tpu/ops/zzero.py, term for term: windowed
mean-vector and max-|z| tests over the slot axis, the window sums taken as
direct shifted adds for k = 1..cp in that order (a cumsum difference loses
precision), then one ``* (1/cp)``.  It is the plain twin of the z-zero
half of the CUDA kernel csrc/xz_zero.cu (ops/stencil_kernels.py).
"""

from __future__ import annotations

import numpy as np
import torch

from urban_road_filter_torch.config import FilterConfig
from urban_road_filter_torch.constants import LABEL_CURB
from urban_road_filter_torch.ops.geometry import RingLayout, f32, sqrt_rn
from urban_road_filter_torch.ops.numerics import param


def _sh(a, k):  # a[j+k]; wrap garbage masked by the j-range test below
    return torch.roll(a, -k, dims=-1)


def z_zero(layout: RingLayout, cfg: FilterConfig) -> RingLayout:
    cp = int(cfg.curb_points)
    p = layout.x.shape[-1]
    if p < 2 * cp + 1:
        return layout
    sq = lambda v: v * v

    x, y, z = layout.x, layout.y, layout.z
    d = sqrt_rn(sq(_sh(x, cp) - _sh(x, -cp)) + sq(_sh(y, cp) - _sh(y, -cp)))

    va1 = torch.zeros_like(x)
    va2 = torch.zeros_like(x)
    vb1 = torch.zeros_like(x)
    vb2 = torch.zeros_like(x)
    absz = torch.abs(z)
    max1 = absz
    max2 = absz
    for k in range(1, cp + 1):
        va1 = va1 + (_sh(x, -k) - x)
        va2 = va2 + (_sh(y, -k) - y)
        vb1 = vb1 + (_sh(x, k) - x)
        vb2 = vb2 + (_sh(y, k) - y)
        max1 = torch.maximum(max1, _sh(absz, -k))
        max2 = torch.maximum(max2, _sh(absz, k))
    inv = float(np.float32(1) / np.float32(cp))
    va1, va2, vb1, vb2 = va1 * inv, va2 * inv, vb1 * inv, vb2 * inv

    bracket = (va1 * vb1 + va2 * vb2) / (
        sqrt_rn(va1 * va1 + va2 * va2) * sqrt_rn(vb1 * vb1 + vb2 * vb2))
    # Cosine-space threshold (see ops/xzero.py); NaN brackets fail it.
    ch = param(cfg.curb_height)
    cond = ((d < 5.0)
            & (bracket >= param(cfg.cos_z))
            & ((max1 - absz >= ch) | (max2 - absz >= ch))
            & (torch.abs(max1 - max2) >= f32(0.05)))
    j_idx = torch.arange(p, device=x.device)[None, :]
    n = layout.counts[:, None]
    cond = cond & (j_idx >= cp) & (j_idx <= n - 1 - cp)
    return layout._replace(label=torch.where(cond, LABEL_CURB, layout.label))
