"""urban_road_filter_torch — the LiDAR road/curb filter in PyTorch for one
NVIDIA Hopper card (H100).

A port of ``urban_road_filter_tpu`` (the JAX/Pallas package beside it,
which stays the reference).  The kernels that the JAX package wrote in
Pallas for the TPU are CUDA C++ here (``csrc/*.cu``), built with ``nvcc``
for ``sm_90a`` on first use (``_build.py``).

Entry points run on the card: ``pipeline.process_scan`` /
``pipeline.packed_scan`` for one scan, ``pipeline.process_batch`` for a
batch (each also as a CUDA-graph replay, ``*_jit``, whose dynamic
parameters are hot-swapped without a re-capture), ``parallel.azimuth_parallel.make_azimuth_pipeline`` for one scan cut
into azimuth wedges, and ``io.replay.ReplayHarness`` (``python -m
urban_road_filter_torch.io.replay``) for a stream of scans.  Each takes ``device=None`` ("cuda"); only an explicit
``device="cpu"`` runs the kernels' plain PyTorch twins.  Below the entry
points each kernel wrapper in ``ops/`` launches its kernel on a CUDA tensor
and runs its twin on a CPU tensor.

Imports neither JAX nor the JAX package: the port carries its own copies
of the JAX-free modules it needs (``config``, ``constants``, ``io``,
``oracle``, ``postprocess``, ``runtime.native``, ``utils.parity``,
``utils.metrics``, ``viz``).
"""

from urban_road_filter_torch.config import FilterConfig, PipelineDims

from urban_road_filter_torch._build import launch_counts, reset_launch_counts
from urban_road_filter_torch.pipeline import (
    ScanResult, pad_scan, pad_scan_planar, packed_scan, packed_scan_jit,
    planarize_batch, process_batch, process_batch_jit, process_scan,
    process_scan_jit, unpack_planes)

__all__ = ["FilterConfig", "PipelineDims", "ScanResult", "launch_counts",
           "pad_scan", "pad_scan_planar", "packed_scan", "packed_scan_jit",
           "planarize_batch", "process_batch", "process_batch_jit",
           "process_scan", "process_scan_jit", "reset_launch_counts",
           "unpack_planes"]
