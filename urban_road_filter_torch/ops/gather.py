"""Per-point labels back from the (ring, slot) layout, gated and packed.

    labels[b, i] = tables[b][ids[b, i], pos[b][i]]   (0 when either index
                                                     is out of range)

The inverse of ops/place.py: every point reads its label from its scan's
layout at its (ring_id, pos) address.  Port of urban_road_filter_tpu/ops/
gather.py:gather_by_group_pos (K11), which the JAX package's batch path
runs once under vmap, fused with the output stage of pipeline.py:199-212,
272-277: the >= 30-point gate ``ok``, the int8 labels, the ROI and
probably-road flags and the packed uint8 wire plane
``label | roi << 2 | probably_road << 3``.  A point is probably road when
its ring id equals ``probably_road_ring`` and is a ring of the table, so
``probably_road_ring == rings`` (the "no ring" id of every point outside
the ROI) flags none, as the oracle returns none (the JAX package flags
them all).  A CUDA tensor goes through the hand-written kernel
csrc/gather_pack.cu, one launch per LANES lanes of a batch; a CPU tensor
through the plain twin below.  Unlike the TPU kernel's i8 path
(gather.py:113), a negative index reads as 0.
"""

from __future__ import annotations

import ctypes

import torch

from urban_road_filter_torch import _build

I32 = torch.int32
U8 = torch.uint8
LANES = 128  # lanes per launch (csrc/gather_pack.cu kLanes)


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


def gather_pack_batch_plain(tables, ids, pos, valid, ok,
                            probably_road_ring: int):
    lanes = [gather_pack_plain(t, ids[b], p, valid[b], ok[b],
                               probably_road_ring)
             for b, (t, p) in enumerate(zip(tables, pos))]
    return tuple(torch.stack(f) for f in zip(*lanes))


def _pointers(ts, lo: int, hi: int):
    """ctypes array of the device pointers of lanes lo..hi-1 of ts: a
    tensor with the lanes leading (its rows by stride, no view made) or a
    sequence of tensors."""
    if isinstance(ts, torch.Tensor):
        step = ts.stride(0) * ts.element_size()
        at = [ts.data_ptr() + k * step for k in range(lo, hi)]
    else:
        at = [t.data_ptr() for t in ts[lo:hi]]
    return (ctypes.c_void_p * (hi - lo))(*at)


def _launch(tables, pos, lo, hi, r, p, ids, valid, ok, prr, n,
            outs) -> None:
    """One K11 launch over lanes lo..hi-1 of tables and pos (hi - lo <=
    LANES): ids, valid, ok and outs have them on their leading axis (none
    for a single scan)."""
    _build.launch("gather_pack", "urf_gather_pack", ids.device,
                  _pointers(tables, lo, hi), _pointers(pos, lo, hi),
                  hi - lo, r, p, _build.ptr(ids), _build.ptr(valid),
                  _build.ptr(ok), int(prr), n, *map(_build.ptr, outs))


def _outputs(shape, dev):
    return tuple(torch.empty(shape, dtype=t, device=dev)
                 for t in (torch.int8, torch.bool, torch.bool, U8))


def gather_pack_batch(tables, ids, pos, valid, ok, probably_road_ring: int):
    """(labels int8, roi bool, probably_road bool, packed uint8), each
    (B, N), of B scans: tables, B (R, P) int32 label tables (a (B, R, P)
    tensor, as the batch path's stages give them, or separate tensors);
    pos, B (N,) int32 slot vectors (likewise (B, N)); ids: (B, N) int32
    ring ids; valid: (B, N) bool ROI masks; ok: (B,) bool scan gates
    (device flags: the host never waits).  On the card one launch per
    LANES lanes, each lane's table and slots passed by pointer, never
    stacked or copied."""
    b = len(tables)
    if len(pos) != b or b == 0:
        raise ValueError(f"expected one pos per table, got {len(pos)} for "
                         f"{b} tables")
    if _build.on_cpu(ids):
        return gather_pack_batch_plain(tables, ids, pos, valid, ok,
                                       probably_road_ring)
    r, p = tables[0].shape
    n = ids.shape[1]
    dev = ids.device
    _build.check(ids, "ids", I32, (b, n), dev)
    _build.check(valid, "valid", torch.bool, (b, n), dev)
    _build.check(ok, "ok", torch.bool, (b,), dev)
    if isinstance(tables, torch.Tensor):
        _build.check(tables, "tables", I32, (b, r, p), dev)
    else:
        for k in range(b):
            _build.check(tables[k], f"tables[{k}]", I32, (r, p), dev)
    if isinstance(pos, torch.Tensor):
        _build.check(pos, "pos", I32, (b, n), dev)
    else:
        for k in range(b):
            _build.check(pos[k], f"pos[{k}]", I32, (n,), dev)
    out = _outputs((b, n), dev)
    for lo in range(0, b, LANES):
        hi = min(lo + LANES, b)
        lanes = (ids, valid, ok, *out)
        if b > LANES:
            lanes = tuple(t[lo:hi] for t in lanes)
        _launch(tables, pos, lo, hi, r, p, *lanes[:3], probably_road_ring,
                n, lanes[3:])
    return out


def gather_pack(table, ids, pos, valid, ok, probably_road_ring: int):
    """gather_pack_batch of one scan: (labels int8, roi bool, probably_road
    bool, packed uint8), all (N,).  table: (R, P) int32 labels; ids/pos:
    (N,) int32; valid: (N,) bool ROI mask; ok: 0-d bool scan gate."""
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
    out = _outputs((n,), dev)
    _launch((table,), (pos,), 0, 1, r, p, ids, valid, ok,
            probably_road_ring, n, out)
    return out
