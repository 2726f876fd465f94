"""Batch-of-scans data parallelism over a list of devices.

Port of urban_road_filter_tpu/parallel/data_parallel.py.  The JAX function
shards a batch's scan axis over a mesh's "data" axis and vmaps the pipeline
per scan.  Here a batch, (B, N, >=3) rows or (3, B, N) planar (named by
``layout``, never guessed from the shape), is cut on its scan axis into
contiguous chunks, one per entry of ``devices``, and each chunk runs
pipeline.process_batch on its device's current stream.  The per-scan
pipeline has no cross-scan dependence, so the chunks need no communication;
the results are joined on ``devices[0]``.

One card may appear more than once: its chunks then go in turn on its one
stream, as K1, K9 and K13's per-device tickets require (_build.TICKETED).
"""

from __future__ import annotations

import torch

from urban_road_filter_torch.config import FilterConfig, PipelineDims
from urban_road_filter_torch.pipeline import (
    ScanResult, process_batch, target_device)

_SCAN_AXIS = {"rows": 0, "planar": 1}


def make_sharded_pipeline(devices, cfg: FilterConfig, dims: PipelineDims):
    """Returns run(pts, cfg_now=None, layout="rows") -> ScanResult with a
    leading B axis on ``devices[0]``: pts, a tensor or host array, is
    (B, N, >=3) for ``layout="rows"`` or (3, B, N) for ``"planar"``; its
    scan axis is split into len(devices) contiguous chunks (sizes differ by
    at most one; a device whose chunk is empty runs nothing).  ``cfg_now``
    replaces ``cfg`` for that call (a hot swap).  With one device, run is
    process_batch itself: no split and no copy."""
    devices = [target_device(d) for d in devices]
    if not devices:
        raise ValueError("make_sharded_pipeline needs at least one device")

    def run(pts, cfg_now: FilterConfig | None = None,
            layout: str = "rows") -> ScanResult:
        c = cfg if cfg_now is None else cfg_now
        if layout not in _SCAN_AXIS:
            raise ValueError(f"layout must be 'rows' or 'planar', got "
                             f"{layout!r}")
        if len(devices) == 1:
            return process_batch(pts, c, dims, layout=layout,
                                 device=devices[0])
        pts = torch.as_tensor(pts)
        axis = _SCAN_AXIS[layout]
        if pts.ndim != 3 or pts.shape[axis] == 0:
            raise ValueError(f"expected a non-empty {layout} batch, got "
                             f"shape {tuple(pts.shape)}")
        parts = [process_batch(chunk, c, dims, layout=layout, device=dev)
                 for dev, chunk in zip(devices, torch.tensor_split(
                     pts, len(devices), dim=axis))
                 if chunk.shape[axis]]
        return ScanResult(*(torch.cat([t.to(devices[0]) for t in field])
                            for field in zip(*parts)))

    return run


__all__ = ["make_sharded_pipeline"]
