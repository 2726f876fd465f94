"""Per-point labels back from the (ring, slot) layout, gated and packed.

    labels[i] = table[ids[i], pos[i]]   (0 when either index is out of range)

The inverse of ops/place.py: every point reads its label from the layout
at its (ring_id, pos) address.  Port of urban_road_filter_tpu/ops/
gather.py:gather_by_group_pos (K11) fused with the output stage of
pipeline.py:199-212,272-277: the >= 30-point gate ``ok``, the int8 labels,
the ROI and probably-road flags and the packed uint8 wire plane
``label | roi << 2 | probably_road << 3``.  A point is probably road when
its ring id equals ``probably_road_ring`` and is a ring of the table, so
``probably_road_ring == rings`` (the "no ring" id of every point outside
the ROI) flags none, as the oracle returns none (the JAX package flags
them all).  A CUDA tensor goes through the hand-written kernel
csrc/gather_pack.cu; a CPU tensor through the plain twin below.  Unlike the
TPU kernel's i8 path (gather.py:113), a negative index reads as 0.
"""

from __future__ import annotations

import torch

from urban_road_filter_torch import _build

I32 = torch.int32
U8 = torch.uint8


def gather_by_group_pos(table, ids, pos):
    """table[ids, pos] by fancy indexing, 0 where (ids, pos) is outside the
    table (the JAX package's off-TPU formulation)."""
    r, p = table.shape
    in_range = (ids >= 0) & (ids < r) & (pos >= 0) & (pos < p)
    safe = table[ids.clamp(0, r - 1).long(), pos.clamp(0, p - 1).long()]
    return torch.where(in_range, safe, 0)


def gather_pack_plain(table, ids, pos, valid, ok, probably_road_ring: int):
    lab = torch.where(ok, gather_by_group_pos(table, ids, pos), 0).to(
        torch.int8)
    roi = valid & ok
    r = table.shape[0]
    pr = (ids == probably_road_ring) & (ids < r) & ok
    packed = lab.to(U8) | (roi.to(U8) << 2) | (pr.to(U8) << 3)
    return lab, roi, pr, packed


def gather_pack(table, ids, pos, valid, ok, probably_road_ring: int):
    """(labels int8, roi bool, probably_road bool, packed uint8), all (N,).
    table: (R, P) int32 labels; ids/pos: (N,) int32; valid: (N,) bool ROI
    mask; ok: 0-d bool scan gate (a device scalar: the host never waits)."""
    if _build.on_cpu(table):
        return gather_pack_plain(table, ids, pos, valid, ok,
                                 probably_road_ring)
    r, p = table.shape
    n = ids.shape[0]
    dev = table.device
    _build.check(table, "table", I32, (r, p), dev)
    _build.check(ids, "ids", I32, (n,), dev)
    _build.check(pos, "pos", I32, (n,), dev)
    _build.check(valid, "valid", torch.bool, (n,), dev)
    _build.check(ok, "ok", torch.bool, (), dev)
    labels = torch.empty((n,), dtype=torch.int8, device=dev)
    roi = torch.empty((n,), dtype=torch.bool, device=dev)
    pr = torch.empty((n,), dtype=torch.bool, device=dev)
    packed = torch.empty((n,), dtype=U8, device=dev)
    _build.launch("gather_pack", "urf_gather_pack", dev,
                  _build.ptr(table), r, p, _build.ptr(ids), _build.ptr(pos),
                  _build.ptr(valid), _build.ptr(ok), int(probably_road_ring),
                  n, _build.ptr(labels), _build.ptr(roi), _build.ptr(pr),
                  _build.ptr(packed))
    return labels, roi, pr, packed
