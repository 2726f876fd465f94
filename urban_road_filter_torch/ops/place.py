"""Placement of 1-3 per-point fields into the padded (rings, capacity) layout.

    out[f][ids[i], pos[i]] = fields[f][i]  where ids[i] < rings
                                           and pos[i] < capacity

Port of the placement inside urban_road_filter_tpu/ops/geometry.py:tensorize
and of ``place.group_place_pallas(ids, pos, fields, ..., counts=...)``.  A
CUDA tensor goes through the hand-written kernel csrc/group_place.cu (K6,
replacing the TPU's one-hot matmul: on Hopper a placement is an indexed
store; a batch of scans with a leading lane axis is one launch); a CPU
tensor through the plain twin below, the JAX package's unique-indices
scatter (geometry.py:211-224).  Empty slots are 0.0;
in-ring points past capacity are dropped and counted in ``overflow``.

``pos`` and ``counts`` come from ops.rank.group_positions over the same
``ids`` (the dense-ranked contract): ring r then holds exactly slots
0 .. min(counts[r], capacity) - 1, so the kernel writes the empty slots
from ``counts`` instead of filling the layout first, and overflow is
sum over r < rings of max(counts[r] - capacity, 0).
"""

from __future__ import annotations

import torch

from urban_road_filter_torch import _build

F32 = torch.float32
I32 = torch.int32


def group_place_plain(ids, pos, counts, fields, rings: int, capacity: int):
    """Scatter with a unique dump slot per dropped point (per lane of a
    batch).  ``counts`` is the kernel's input; the scatter does not need
    it."""
    if ids.ndim == 2:
        return tuple(torch.stack(f) for f in zip(*(
            group_place_plain(i, q, c, f, rings, capacity)
            for i, q, c, *f in zip(ids, pos, counts, *fields))))
    n = ids.shape[0]
    p = capacity
    in_ring = ids < rings
    fits = in_ring & (pos < p)
    iota = torch.arange(n, dtype=I32, device=ids.device)
    dst = torch.where(fits, ids * p + pos, rings * p + iota).long()
    outs = []
    for v in fields:
        buf = torch.zeros((rings * p + n,), dtype=F32, device=ids.device)
        buf[dst] = v.to(F32)
        outs.append(buf[:rings * p].reshape(rings, p))
    overflow = torch.sum(in_ring & (pos >= p)).to(I32)
    return (*outs, overflow)


def group_place(ids, pos, counts, fields, rings: int, capacity: int):
    """(*outs, overflow): one (rings, capacity) f32 plane per field and the
    0-d int32 count of in-ring points dropped for capacity.  ids/pos: (N,)
    int32 with pos >= 0; counts: (>= rings,) int32 group totals; fields: a
    sequence of 1-3 (N,) f32 tensors, any element stride.  With a leading
    lane axis (ids, pos and fields (B, N), counts (B, >= rings); fields any
    strides): (B, rings, capacity) planes and (B,) overflows, from one
    launch."""
    if _build.on_cpu(ids):
        return group_place_plain(ids, pos, counts, fields, rings, capacity)
    one = ids.ndim == 1
    if one:
        ids, pos, counts = ids[None], pos[None], counts[None]
        fields = [v[None] for v in fields]
    b, n = ids.shape
    dev = ids.device
    nf = len(fields)
    if not 1 <= nf <= 3:
        raise ValueError(f"group_place takes 1-3 fields, got {nf}")
    _build.check(ids, "ids", I32, (b, n))
    _build.check(pos, "pos", I32, (b, n), dev)
    _build.check(counts, "counts", I32, None, dev, contiguous=False)
    if (counts.ndim != 2 or counts.shape[0] != b or counts.shape[1] < rings
            or counts.stride(1) != 1):
        raise ValueError(f"counts: expected ({rings} or more,) per lane, "
                         f"unit stride, got {tuple(counts.shape)}")
    for k, v in enumerate(fields):
        _build.check(v, f"fields[{k}]", F32, (b, n), dev, contiguous=False)
    out = torch.empty((nf, b, rings, capacity), dtype=F32, device=dev)
    overflow = torch.empty((b,), dtype=I32, device=dev)
    padded = [*fields, *fields[:1] * (3 - nf)]
    _build.launch("group_place", "urf_group_place", dev,
                  _build.ptr(ids), _build.ptr(pos), _build.ptr(counts),
                  counts.stride(0), n, b, nf, *map(_build.ptr, padded),
                  *(v.stride(1) for v in padded),
                  *(v.stride(0) for v in padded),
                  rings, capacity, _build.ptr(out), _build.ptr(overflow))
    if one:
        return (*(o[0] for o in out.unbind(0)), overflow[0])
    return (*out.unbind(0), overflow)
