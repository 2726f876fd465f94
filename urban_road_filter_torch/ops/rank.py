"""Stable group ranking: position of each element within its group.

``group_positions(ids, num_groups)`` returns, for every element, the number
of EARLIER elements with the same group id (its slot in a stable grouped
layout) plus the per-group totals: the primitive behind tensorization
(points -> (ring, slot)).

Port of urban_road_filter_tpu/ops/rank.py.  A CUDA tensor goes through the
hand-written kernel csrc/group_place.cu (K5, one cooperative launch:
per-tile histograms, one warp per group scanning its column over the tiles,
then a warp-match rank inside each tile with the warps taken in order; a
batch of scans with a leading lane axis is one launch, its histograms per
lane); a CPU tensor through the plain twin below, which has the semantics
of the JAX ``_xla_rank``.
"""

from __future__ import annotations

import torch

from urban_road_filter_torch import _build

I32 = torch.int32
_BLOCK = 1024  # points per tile of the rank kernel (csrc/group_place.cu)


def group_positions_plain(ids: torch.Tensor, num_groups: int):
    """Stable sort by id; position = sorted index - group start (per lane
    of a batch)."""
    if ids.ndim == 2:
        return tuple(torch.stack(f) for f in zip(
            *(group_positions_plain(lane, num_groups) for lane in ids)))
    n = ids.shape[0]
    iota = torch.arange(n, dtype=I32, device=ids.device)
    ids_s, idx_s = torch.sort(ids, stable=True)
    counts = torch.bincount(ids.long(), minlength=num_groups)[:num_groups]
    starts = (torch.cumsum(counts, 0) - counts).to(I32)
    pos_s = iota - starts[torch.clamp(ids_s.long(), 0, num_groups - 1)]
    pos = torch.empty_like(ids)
    pos[idx_s] = pos_s
    return pos, counts.to(I32)


def group_positions(ids: torch.Tensor, num_groups: int):
    """(pos, counts): pos[i] = # of j < i with ids[j] == ids[i];
    counts[g] = total elements of group g.  ids: (N,) int32 in
    [0, num_groups).  With a leading lane axis (ids (B, N)): pos (B, N)
    and counts (B, num_groups), each lane ranked on its own, from one
    launch."""
    if _build.on_cpu(ids):
        return group_positions_plain(ids, num_groups)
    one = ids.ndim == 1
    ids2 = ids[None] if one else ids
    b, n = ids2.shape
    _build.check(ids2, "ids", I32, (b, n))
    pos = torch.empty_like(ids2)
    counts = torch.empty((b, num_groups), dtype=I32, device=ids.device)
    hist = torch.empty((b * max(1, -(-n // _BLOCK)) * num_groups,),
                       dtype=I32, device=ids.device)
    _build.launch("group_rank", "urf_group_rank", ids.device,
                  _build.ptr(ids2), n, num_groups, b, _build.ptr(pos),
                  _build.ptr(counts), _build.ptr(hist))
    return (pos[0], counts[0]) if one else (pos, counts)
