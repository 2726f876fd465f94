"""Both curb stencils (x-zero and z-zero) in one kernel pass, in place.

Port of urban_road_filter_tpu/ops/pallas_kernels.py:fused_xz_zero (K7).  A
CUDA layout goes through the hand-written kernel csrc/xz_zero.cu, which
repeats the arithmetic of ops/xzero.py and ops/zzero.py operation for
operation (bit-equal labels) and writes LABEL_CURB into the label table
it is given, only where a stencil marks; a CPU layout through those two
plain twins.  The azimuth-sharded path runs the same kernel on its stacked
wedge rows, each row's windows reaching into the halo points of the
wedges around it (``fused_xz_zero_halo``; plain twin
``xz_zero_halo_plain``), with the newY ladder at global ring positions.
"""

from __future__ import annotations

import ctypes

import torch

from urban_road_filter_torch.config import FilterConfig, device_config
from urban_road_filter_torch import _build
from urban_road_filter_torch.constants import LABEL_CURB
from urban_road_filter_torch.ops.geometry import RingLayout, stacked_rows
from urban_road_filter_torch.ops.xzero import new_y_ladder, x_zero
from urban_road_filter_torch.ops.zzero import z_zero

F32 = torch.float32
I32 = torch.int32


def _thresholds(cfg):
    """Pointers to cos_x, cos_z and curb_height in a bound
    configuration's parameter buffer (config.device_config): the kernel
    reads them from device memory."""
    return tuple(_build.ptr(getattr(cfg, k))
                 for k in ("cos_x", "cos_z", "curb_height"))


def xz_zero_plain(layout: RingLayout, cfg: FilterConfig,
                  ladder_offset=None, ladder_len: int | None = None
                  ) -> RingLayout:
    """The plain twin of fused_xz_zero: x_zero, then z_zero, as enabled."""
    if cfg.x_zero_method:
        layout = x_zero(layout, cfg, new_y_ladder(
            layout.x.shape[1], ladder_offset, ladder_len,
            device=layout.x.device))
    if cfg.z_zero_method:
        layout = z_zero(layout, cfg)
    return layout


def fused_xz_zero_(layout: RingLayout, cfg: FilterConfig,
                   ladder_offset=None, ladder_len: int | None = None) -> None:
    """Curb marks of the enabled stencils written into ``layout.label`` in
    place (LABEL_CURB where a stencil marks, no other slot changed).
    x-zero reads newY at slot j, or with ``ladder_offset`` ((R,) int32) at
    clip(ladder_offset[ring] + j, 0, ladder_len - 1).  The marks do not
    depend on the label, so a second call changes nothing.  The stencils
    work row by row, so a batch's (B, R, P) layout is marked as its
    (B * R, P) stacked rows (geometry.stacked_rows), in one launch."""
    layout = stacked_rows(layout)
    cp = int(cfg.curb_points)
    do_x, do_z = bool(cfg.x_zero_method), bool(cfg.z_zero_method)
    r, p = layout.x.shape
    if p < 2 * cp + 1 or not (do_x or do_z):
        return
    if ladder_offset is not None and (ladder_len is None or ladder_len < 1):
        raise ValueError("ladder_offset needs a positive ladder_len")
    if _build.on_cpu(layout.x):
        layout.label.copy_(xz_zero_plain(layout, cfg, ladder_offset,
                                         ladder_len).label)
        return
    dev = layout.x.device
    cfg = device_config(cfg, dev)
    for name in ("x", "y", "z"):
        _build.check(getattr(layout, name), name, F32, (r, p), dev)
    _build.check(layout.counts, "counts", I32, (r,), dev)
    _build.check(layout.label, "label", I32, (r, p), dev)
    off = ctypes.c_void_p(None)
    if ladder_offset is not None:
        _build.check(ladder_offset, "ladder_offset", I32, (r,), dev)
        off = _build.ptr(ladder_offset)
    _build.launch("xz_zero", "urf_xz_zero", dev,
                  _build.ptr(layout.x), _build.ptr(layout.y),
                  _build.ptr(layout.z), _build.ptr(layout.counts),
                  _build.ptr(layout.label), off,
                  p if ladder_offset is None else ladder_len, r, p, cp,
                  int(do_x), int(do_z), *_thresholds(cfg))


def fused_xz_zero(layout: RingLayout, cfg: FilterConfig,
                  ladder_offset=None, ladder_len: int | None = None
                  ) -> RingLayout:
    """``layout`` with a new label: a copy of its label with the curb marks
    of fused_xz_zero_ (the input is not changed)."""
    out = layout._replace(label=layout.label.clone())
    fused_xz_zero_(out, cfg, ladder_offset, ladder_len)
    return out


def xz_zero_halo_plain(layout: RingLayout, left: dict, right: dict,
                       prefix: torch.Tensor, total: torch.Tensor,
                       cfg: FilterConfig,
                       n_wedges: int | None = None) -> torch.Tensor:
    """The plain twin of fused_xz_zero_halo: the stacked layout's new label
    table.  It builds halo-extended rows [cp dummy | left halo | local P |
    right halo] in memory, runs x_zero (newY at global ring positions)
    and z_zero over them, and keeps the marks that pass the reference's
    j-range gate in global positions, whose windows hold only points, and
    that land on local slots (the JAX _extend_with_halo, _x_zero_halo and
    _z_zero_halo)."""
    d, rings, cp = left["x"].shape
    cap = layout.x.shape[1]
    p_ext = cap + 3 * cp
    dev = layout.x.device
    counts = layout.counts.view(d, rings, 1)
    col = torch.arange(p_ext, device=dev)
    s = col - 2 * cp  # local slot; negative = left halo
    kr = s - counts  # right-halo index of a column past the local points
    in_right = (kr >= 0) & (kr < right["n"][..., None])
    ext = {}
    for name in ("x", "y", "z"):
        loc = getattr(layout, name).view(d, rings, cap)
        e = torch.cat([torch.zeros((d, rings, cp), dtype=F32, device=dev),
                       left[name], loc,
                       torch.zeros((d, rings, cp), dtype=F32, device=dev)],
                      dim=2)
        rv = torch.gather(right[name], 2,
                          torch.clamp(kr, 0, cp - 1).expand(d, rings, p_ext))
        ext[name] = torch.where(in_right, rv, e).reshape(d * rings, p_ext)
    label = torch.nn.functional.pad(layout.label, (2 * cp, cp))
    ext_layout = layout._replace(
        x=ext["x"], y=ext["y"], z=ext["z"],
        label=torch.zeros_like(label),
        counts=torch.full((d * rings,), p_ext, dtype=I32, device=dev))

    g = prefix[..., None] + s  # (D, R, p_ext) global ring position
    n_local = counts
    exists = ((s >= -left["n"][..., None])
              & (s < n_local + right["n"][..., None]))
    g_gate = (g >= cp) & (g <= total[:, None] - 1 - cp)
    in_row = s + 3 * cp < p_ext  # the window end col + cp stays in the row
    local = (s >= 0) & (s < n_local)

    def flat(m):
        return m.reshape(d * rings, p_ext)

    if cfg.x_zero_method:
        marks = x_zero(ext_layout, cfg, new_y_ladder(
            p_ext, (prefix - 2 * cp).reshape(-1).to(I32),
            cap * (n_wedges or d), device=dev)).label == LABEL_CURB
        src_ok = (g_gate & exists & torch.roll(exists, -cp, dims=-1)
                  & in_row)
        at_mark = torch.roll(src_ok, cp // 2, dims=-1)
        label = torch.where(marks & (label != LABEL_CURB) & flat(at_mark)
                            & flat(local), LABEL_CURB, label)
    if cfg.z_zero_method:
        marks = z_zero(ext_layout, cfg).label == LABEL_CURB
        window_ok = (torch.roll(exists, cp, dims=-1)
                     & torch.roll(exists, -cp, dims=-1) & in_row)
        label = torch.where(marks & (label != LABEL_CURB)
                            & flat(local & g_gate & window_ok),
                            LABEL_CURB, label)
    return label[:, 2 * cp:-cp]


def fused_xz_zero_halo(layout: RingLayout, left: dict, right: dict,
                       prefix: torch.Tensor, total: torch.Tensor,
                       cfg: FilterConfig, n_wedges: int | None = None) -> None:
    """The curb stencils of the azimuth-sharded path, in place on the
    stacked (D * R, cap) layout's label, one launch over every wedge: each
    row's windows reach into the cp points before and after the wedge's
    segment of the ring (``left`` right-aligned and ``right`` left-aligned
    (D, R, cp) x/y/z blocks with their valid counts "n" (D, R), as the
    path's halo exchange gives them); ``prefix`` (D, R) is the global ring
    position of each row's slot 0, ``total`` (R,) each ring's point count;
    newY at clip(prefix + slot, 0, cap * n_wedges - 1), n_wedges being the
    wedges of the whole scan (default D, every wedge stacked here).  Only
    local slots are marked."""
    do_x, do_z = bool(cfg.x_zero_method), bool(cfg.z_zero_method)
    if not (do_x or do_z):
        return
    d, rings, cp = left["x"].shape
    if cp != int(cfg.curb_points):
        raise ValueError(f"halo blocks of {cp} points for curb_points "
                         f"{cfg.curb_points}")
    rows, cap = layout.x.shape
    if _build.on_cpu(layout.x):
        layout.label.copy_(xz_zero_halo_plain(layout, left, right, prefix,
                                              total, cfg, n_wedges))
        return
    dev = layout.x.device
    cfg = device_config(cfg, dev)
    for name in ("x", "y", "z"):
        _build.check(getattr(layout, name), name, F32, (d * rings, cap), dev)
        for side, blocks in (("left", left), ("right", right)):
            _build.check(blocks[name], f"{side} {name}", F32, (d, rings, cp),
                         dev)
    _build.check(layout.counts, "counts", I32, (rows,), dev)
    _build.check(layout.label, "label", I32, (rows, cap), dev)
    for side, blocks in (("left", left), ("right", right)):
        _build.check(blocks["n"], f"{side} n", I32, (d, rings), dev)
    _build.check(prefix, "prefix", I32, (d, rings), dev)
    _build.check(total, "total", I32, (rings,), dev)
    _build.launch("xz_zero", "urf_xz_zero_halo", dev,
                  _build.ptr(layout.x), _build.ptr(layout.y),
                  _build.ptr(layout.z), _build.ptr(layout.counts),
                  _build.ptr(layout.label),
                  *(_build.ptr(left[k]) for k in ("x", "y", "z", "n")),
                  *(_build.ptr(right[k]) for k in ("x", "y", "z", "n")),
                  _build.ptr(prefix), _build.ptr(total), rings,
                  cap * (n_wedges or d),
                  rows, cap, cp, int(do_x), int(do_z), *_thresholds(cfg))
