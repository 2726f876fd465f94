"""Placement of x/y/z into the padded (rings, capacity) layout.

    out[ids[i], pos[i]] = field[i]   when ids[i] < rings and pos[i] < capacity

Port of the placement inside urban_road_filter_tpu/ops/geometry.py:tensorize.
A CUDA tensor goes through the hand-written kernel csrc/group_place.cu (K6,
replacing the TPU's one-hot matmul ``place.group_place_pallas``: on Hopper a
placement is an indexed store); a CPU tensor through the plain twin below,
the JAX package's unique-indices scatter (geometry.py:211-224).  Empty slots
are 0.0; in-ring points past capacity are dropped and counted in
``overflow``.
"""

from __future__ import annotations

import torch

from urban_road_filter_torch import _build

F32 = torch.float32
I32 = torch.int32


def group_place_plain(ids, pos, x, y, z, rings: int, capacity: int):
    """Scatter with a unique dump slot per dropped point."""
    n = ids.shape[0]
    p = capacity
    in_ring = ids < rings
    fits = in_ring & (pos < p)
    iota = torch.arange(n, dtype=I32, device=ids.device)
    dst = torch.where(fits, ids * p + pos, rings * p + iota).long()
    outs = []
    for v in (x, y, z):
        buf = torch.zeros((rings * p + n,), dtype=F32, device=ids.device)
        buf[dst] = v.to(F32)
        outs.append(buf[:rings * p].reshape(rings, p))
    overflow = torch.sum(in_ring & (pos >= p)).to(I32)
    return outs[0], outs[1], outs[2], overflow


def group_place(ids, pos, x, y, z, rings: int, capacity: int):
    """(out_x, out_y, out_z, overflow): (rings, capacity) f32 fields and the
    0-d int32 count of in-ring points dropped for capacity.  ids/pos: (N,)
    int32 with pos >= 0; x/y/z: (N,) f32."""
    if _build.on_cpu(ids):
        return group_place_plain(ids, pos, x, y, z, rings, capacity)
    n = ids.shape[0]
    dev = ids.device
    _build.check(ids, "ids", I32, (n,))
    _build.check(pos, "pos", I32, (n,), dev)
    fields = [v.contiguous() for v in (x, y, z)]
    for name, v in zip("xyz", fields):
        _build.check(v, name, F32, (n,), dev)
    outs = [torch.zeros((rings, capacity), dtype=F32, device=dev)
            for _ in range(3)]
    overflow = torch.zeros((), dtype=I32, device=dev)
    _build.launch("group_place", "urf_group_place", dev,
                  _build.ptr(ids), _build.ptr(pos), n,
                  *map(_build.ptr, fields), rings, capacity,
                  *map(_build.ptr, outs), _build.ptr(overflow))
    return outs[0], outs[1], outs[2], overflow
