"""Both curb stencils (x-zero and z-zero) in one kernel pass.

Port of urban_road_filter_tpu/ops/pallas_kernels.py:fused_xz_zero (K7).  A
CUDA layout goes through the hand-written kernel csrc/xz_zero.cu, which
repeats the arithmetic of ops/xzero.py and ops/zzero.py operation for
operation (bit-equal labels); a CPU layout through those two plain twins.
"""

from __future__ import annotations

import torch

from urban_road_filter_tpu.config import FilterConfig
from urban_road_filter_torch import _build
from urban_road_filter_torch.ops.geometry import RingLayout, f32
from urban_road_filter_torch.ops.xzero import x_zero
from urban_road_filter_torch.ops.zzero import z_zero

F32 = torch.float32
I32 = torch.int32


def fused_xz_zero(layout: RingLayout, cfg: FilterConfig) -> RingLayout:
    """Curb marks of the enabled stencils on ``layout.label``."""
    cp = int(cfg.curb_points)
    do_x, do_z = bool(cfg.x_zero_method), bool(cfg.z_zero_method)
    r, p = layout.x.shape
    if p < 2 * cp + 1 or not (do_x or do_z):
        return layout
    if _build.on_cpu(layout.x):
        if do_x:
            layout = x_zero(layout, cfg)
        if do_z:
            layout = z_zero(layout, cfg)
        return layout
    dev = layout.x.device
    for name in ("x", "y", "z"):
        _build.check(getattr(layout, name), name, F32, (r, p), dev)
    _build.check(layout.counts, "counts", I32, (r,), dev)
    _build.check(layout.label, "label", I32, (r, p), dev)
    out = torch.empty_like(layout.label)
    _build.launch("xz_zero", "urf_xz_zero", dev,
                  _build.ptr(layout.x), _build.ptr(layout.y),
                  _build.ptr(layout.z), _build.ptr(layout.counts),
                  _build.ptr(layout.label), _build.ptr(out), r, p, cp,
                  int(do_x), int(do_z), f32(cfg.cos_x), f32(cfg.cos_z),
                  f32(cfg.curb_height))
    return layout._replace(label=out)
