"""x-zero curb detection (reference: x_zero_method.cpp:7-71), plain PyTorch.

Port of urban_road_filter_tpu/ops/xzero.py, term for term: a stencil over
the slot axis of the (rings, slots) layout with windows (j, j+cp/2, j+cp)
on the synthetic 0.01-spaced ``newY`` ladder.  It is the plain twin of the
x-zero half of the CUDA kernel csrc/xz_zero.cu (ops/stencil_kernels.py).
"""

from __future__ import annotations

import numpy as np
import torch

from urban_road_filter_torch.config import FilterConfig
from urban_road_filter_torch.constants import LABEL_CURB
from urban_road_filter_torch.ops.geometry import RingLayout, f32, sqrt_rn
from urban_road_filter_torch.ops.numerics import param


def _new_y_table(p: int) -> np.ndarray:
    """newY[j] = j * 0.01, float64 accumulation rounded to f32 (matches the
    oracle; the C++ accumulates sequentially in f32, <=1 ulp apart)."""
    return (np.arange(p, dtype=np.float64) * 0.01).astype(np.float32)


def _sh(a, k):  # a[j+k] along the slot axis (wrap garbage is masked out)
    return torch.roll(a, -k, dims=-1)


def new_y_ladder(p: int, offset=None, length: int | None = None,
                 device=None) -> torch.Tensor:
    """newY values per slot: (p,) newY[j], or with a per-ring ``offset``
    (R,) int32, (R, p) newY[clip(offset + j, 0, length - 1)] (the
    azimuth-sharded path's global ring positions,
    urban_road_filter_tpu/parallel/azimuth_parallel.py:_x_zero_halo)."""
    if offset is None:
        return torch.as_tensor(_new_y_table(p), device=device)
    k = torch.clamp(offset.long()[:, None]
                    + torch.arange(p, device=offset.device), 0, length - 1)
    return (k.double() * 0.01).float()


def x_zero(layout: RingLayout, cfg: FilterConfig, new_y=None) -> RingLayout:
    """``new_y``: optional (P,) or (R, P) newY values per slot
    (new_y_ladder), as the JAX x_zero's; default the 0-based ladder."""
    cp = int(cfg.curb_points)
    p = layout.x.shape[-1]
    if p < 2 * cp + 1:
        return layout
    if new_y is None:
        new_y = new_y_ladder(p, device=layout.x.device)
    sq = lambda v: v * v

    x, y, z = layout.x, layout.y, layout.z
    h = cp // 2
    dny1 = _sh(new_y, h) - new_y  # newY[p2]-newY[j], constant per slot
    dny2 = _sh(new_y, cp) - _sh(new_y, h)
    dny3 = _sh(new_y, cp) - new_y

    d = sqrt_rn(sq(_sh(x, cp) - x) + sq(_sh(y, cp) - y))
    x1 = sqrt_rn(sq(dny1) + sq(_sh(z, h) - z))
    x2 = sqrt_rn(sq(dny2) + sq(_sh(z, cp) - _sh(z, h)))
    x3 = sqrt_rn(sq(dny3) + sq(_sh(z, cp) - z))

    # acos(clip(b)) <= angleFilter1  <=>  b >= cos(angleFilter1); cos_x is
    # host-precomputed in float64 (config.py).
    bracket = (x3 * x3 - x1 * x1 - x2 * x2) / (-2.0 * x1 * x2)
    ch = param(cfg.curb_height)
    cond = ((d < 5.0)
            & (bracket >= param(cfg.cos_x))
            & ((torch.abs(z - _sh(z, h)) >= ch)
               | (torch.abs(_sh(z, cp) - _sh(z, h)) >= ch))
            & (torch.abs(z - _sh(z, cp)) >= f32(0.05)))

    # j ranges over [cp, n-1-cp] (x_zero_method.cpp:30); the mark lands on
    # p2 = j + cp/2 (cpp:66).
    j_idx = torch.arange(p, device=x.device)[None, :]
    n = layout.counts[:, None]
    cond = cond & (j_idx >= cp) & (j_idx <= n - 1 - cp)
    mark = torch.roll(cond, h, dims=-1)  # mark[j + cp//2] = cond[j]
    return layout._replace(label=torch.where(mark, LABEL_CURB, layout.label))
