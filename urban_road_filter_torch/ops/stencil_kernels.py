"""Both curb stencils (x-zero and z-zero) in one kernel pass.

Port of urban_road_filter_tpu/ops/pallas_kernels.py:fused_xz_zero (K7).  A
CUDA layout goes through the hand-written kernel csrc/xz_zero.cu, which
repeats the arithmetic of ops/xzero.py and ops/zzero.py operation for
operation (bit-equal labels); a CPU layout through those two plain twins.
The azimuth-sharded path also runs it on halo-extended rows, with the newY
ladder at global ring positions (``ladder_offset``, ``ladder_len``).
"""

from __future__ import annotations

import ctypes

import torch

from urban_road_filter_torch.config import FilterConfig
from urban_road_filter_torch import _build
from urban_road_filter_torch.ops.geometry import RingLayout, f32
from urban_road_filter_torch.ops.xzero import new_y_ladder, x_zero
from urban_road_filter_torch.ops.zzero import z_zero

F32 = torch.float32
I32 = torch.int32


def fused_xz_zero(layout: RingLayout, cfg: FilterConfig,
                  ladder_offset=None, ladder_len: int | None = None
                  ) -> RingLayout:
    """Curb marks of the enabled stencils on ``layout.label``.  x-zero reads
    newY at slot j, or with ``ladder_offset`` ((R,) int32) at
    clip(ladder_offset[ring] + j, 0, ladder_len - 1)."""
    cp = int(cfg.curb_points)
    do_x, do_z = bool(cfg.x_zero_method), bool(cfg.z_zero_method)
    r, p = layout.x.shape
    if p < 2 * cp + 1 or not (do_x or do_z):
        return layout
    if ladder_offset is not None and (ladder_len is None or ladder_len < 1):
        raise ValueError("ladder_offset needs a positive ladder_len")
    if _build.on_cpu(layout.x):
        if do_x:
            layout = x_zero(layout, cfg, new_y_ladder(
                p, ladder_offset, ladder_len, device=layout.x.device))
        if do_z:
            layout = z_zero(layout, cfg)
        return layout
    dev = layout.x.device
    for name in ("x", "y", "z"):
        _build.check(getattr(layout, name), name, F32, (r, p), dev)
    _build.check(layout.counts, "counts", I32, (r,), dev)
    _build.check(layout.label, "label", I32, (r, p), dev)
    off = ctypes.c_void_p(None)
    if ladder_offset is not None:
        _build.check(ladder_offset, "ladder_offset", I32, (r,), dev)
        off = _build.ptr(ladder_offset)
    out = torch.empty_like(layout.label)
    _build.launch("xz_zero", "urf_xz_zero", dev,
                  _build.ptr(layout.x), _build.ptr(layout.y),
                  _build.ptr(layout.z), _build.ptr(layout.counts),
                  _build.ptr(layout.label), off,
                  p if ladder_offset is None else ladder_len,
                  _build.ptr(out), r, p, cp,
                  int(do_x), int(do_z), f32(cfg.cos_x), f32(cfg.cos_z),
                  f32(cfg.curb_height))
    return layout._replace(label=out)
