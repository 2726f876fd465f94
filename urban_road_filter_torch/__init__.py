"""urban_road_filter_torch — the LiDAR road/curb filter in PyTorch for one
NVIDIA Hopper card (H100).

A port of ``urban_road_filter_tpu`` (the JAX/Pallas package beside it,
which stays the reference).  Plain functions on tensors; every function
runs on the device of the tensor it is given.  The kernels that the JAX
package wrote in Pallas for the TPU are CUDA C++ here (``csrc/*.cu``),
built with ``nvcc`` for ``sm_90a`` on first use (``_build.py``).  On a CPU
tensor each kernel wrapper runs its plain PyTorch twin; on a CUDA tensor it
launches the kernel or raises.

Imports no JAX: only the JAX-free modules of the reference package
(``config``, ``constants``, ``io.synthetic``).

Entry points: ``pipeline.process_scan`` / ``pipeline.packed_scan`` for one
scan, ``pipeline.process_batch`` for a batch.
"""

from urban_road_filter_tpu.config import FilterConfig, PipelineDims

from urban_road_filter_torch._build import launch_counts, reset_launch_counts
from urban_road_filter_torch.pipeline import (
    ScanResult, pad_scan, pad_scan_planar, packed_scan, planarize_batch,
    process_batch, process_scan, unpack_planes)

__all__ = ["FilterConfig", "PipelineDims", "ScanResult", "launch_counts",
           "pad_scan", "pad_scan_planar", "packed_scan", "planarize_batch",
           "process_batch", "process_scan", "reset_launch_counts",
           "unpack_planes"]
