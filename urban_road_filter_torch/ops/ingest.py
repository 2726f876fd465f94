"""Batch ingest on (B, N) point streams: ROI mask, star keys, ring binning.

Port of urban_road_filter_tpu/ops/ingest_scan.py, the ingest the JAX
package's batch path runs once over the (B, N) streams
(pipeline.py:_ingest_batch_tpu); here the single-scan path runs the same
functions at B = 1.

    ingest_prep     (K1)  ROI mask, star sector + radius keys, in-ROI count
    discover_rings  (K2)  greedy ring registration per scan, sorted table
    assign_rings    (K3)  first matching ring per point (bisects the table)

Each function launches its hand-written kernel (csrc/ingest.cu) on a CUDA
tensor, or raises; on a CPU tensor it runs its plain PyTorch twin
(``*_plain``), which the tests hold against the JAX package.  Each launch
is one kernel (K1 zeroes its in-ROI counts itself; K2 zeroes its arrival
counters with a memset, and sorts its table itself: no ``torch.sort``);
``last_grid`` keeps the grid of each kernel's latest launch.  Every
threshold is rounded to float32 on the host first, as the JAX package
does.  The kernels read the thresholds from device memory (the ROI bounds
and the interval of config.device_config's parameter buffer), so a
captured graph takes new values without a re-capture; the wrappers take
the interval as a 0-d tensor there, or a host scalar.

The sector follows the oracle's binning, not the JAX package's: the float64
atan2 rounded to float32 (the JAX package fed the kernel an f32 XLA atan2
only because Mosaic has none).  Ring discovery keeps the oracle's
semantics on a valid point whose vertical angle is NaN: such a point
becomes a ring and fills every later round with NaN
(discover_rings_pallas reads NaN as a dropped point instead; ROADMAP
queue 3, reference fault 5).
"""

from __future__ import annotations

import ctypes
import math

import torch

from urban_road_filter_torch.config import (
    DYN_INDEX, FilterConfig, device_config)
from urban_road_filter_torch.constants import CHANNELS, STAR_KFI, STAR_REP
from urban_road_filter_torch import _build
from urban_road_filter_torch.ops.numerics import (
    F32, I32, f32, param, param_tensor, roi_mask_xyz, sqrt_rn)

MAX_RINGS = 128  # the kernels' shared-memory ring table (csrc/ingest.cu)
# K1 reads the six ROI bounds as one run of the parameter buffer.
_ROI = tuple(DYN_INDEX[k] for k in ("min_x", "max_x", "min_y", "max_y",
                                    "min_z", "max_z"))
assert _ROI == tuple(range(_ROI[0], _ROI[0] + 6)), _ROI

# Kernel name -> (grid.x, grid.y) of its latest launch.
last_grid: dict = {}


def _launch(kernel: str, fn: str, device, *args) -> None:
    """_build.launch with the grid the entry point reports kept in
    last_grid."""
    grid = (ctypes.c_int * 2)()
    _build.launch(kernel, fn, device, *args,
                  ctypes.c_void_p(ctypes.addressof(grid)))
    last_grid[kernel] = (grid[0], grid[1])


def ingest_prep_plain(x, y, z, cfg: FilterConfig, want_star_keys=True):
    valid = roi_mask_xyz(x, y, z, cfg)
    piece = torch.sum(valid, dim=-1, dtype=I32)
    if not want_star_keys:
        return valid, None, None, piece
    r = sqrt_rn(x * x + y * y)
    fi = torch.atan2(y.double(), x.double()).float()
    fi = torch.where(fi < 0, (fi.double() + 2.0 * math.pi).float(), fi)
    # A sector index of 360 (fi a few ulps below 2 pi) is beam 0's.
    f = (fi * f32(STAR_KFI)).to(I32) % STAR_REP
    return (valid, torch.where(valid, f, STAR_REP),
            torch.where(valid, r, math.inf), piece)


def ingest_prep(x, y, z, cfg: FilterConfig, want_star_keys: bool = True):
    """(valid (B, N) bool, fk (B, N) int32, r_key (B, N) f32, piece (B,)
    int32) from (B, N) coordinate views sharing one stride pattern (a
    rows batch's columns or a planar batch's planes, uncopied).

    valid is the ROI mask; fk the star sector of each ROI point, STAR_REP
    elsewhere; r_key its 2-D radius, +inf elsewhere; piece the in-ROI count
    per scan.  ``want_star_keys=False`` skips fk and r_key (None).  On the
    card one device op: a batch's planes and rows of 4 floats are read a
    float4 at a time; other strides, and calls that fit one wave of
    blocks (a single scan), point by point."""
    if _build.on_cpu(x):
        return ingest_prep_plain(x, y, z, cfg, want_star_keys)
    if x.ndim != 2:
        raise ValueError(f"x must be (B, N), got {tuple(x.shape)}")
    b, n = x.shape
    dev = x.device
    for name, t in zip("xyz", (x, y, z)):
        if (t.device != dev or t.dtype != F32 or t.shape != x.shape
                or t.stride() != x.stride()):
            raise ValueError(f"{name}: expected float32 {tuple(x.shape)} on "
                             f"{dev} with strides {x.stride()}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device} "
                             f"with strides {t.stride()}")
    valid = torch.empty((b, n), dtype=torch.bool, device=dev)
    piece = torch.empty((b,), dtype=I32, device=dev)  # zeroed by the launch
    fk = r_key = None
    keys = (ctypes.c_void_p(None), ctypes.c_void_p(None))
    if want_star_keys:
        fk = torch.empty((b, n), dtype=I32, device=dev)
        r_key = torch.empty((b, n), dtype=F32, device=dev)
        keys = (_build.ptr(fk), _build.ptr(r_key))
    roi = device_config(cfg, dev).params[_ROI[0]:_ROI[0] + 6]
    _launch("ingest_prep", "urf_ingest_prep", dev, _build.ptr(x),
            _build.ptr(y), _build.ptr(z), b, n, x.stride(0), x.stride(1),
            _build.ptr(roi), f32(STAR_KFI), int(want_star_keys),
            _build.ptr(valid), *keys, _build.ptr(piece))
    return valid, fk, r_key, piece


def _check_rings(rings: int) -> None:
    if not 0 <= rings <= MAX_RINGS:
        raise ValueError(f"ring tables hold at most {MAX_RINGS} rings, "
                         f"got {rings}")


def discover_rings_plain(alpha, valid, interval, rings: int):
    """A ``rings``-step loop of vectorized matching over all scans at once
    (the JAX package's geometry.discover_rings, per scan): ring k+1's
    representative is the first point matching none of rings 0..k."""
    tol = param(interval)
    b = alpha.shape[0]
    dev = alpha.device
    inf = torch.full((b, 1), math.inf, dtype=F32, device=dev)
    angles = torch.full((b, rings), math.inf, dtype=F32, device=dev)
    matched = torch.zeros_like(valid)
    count = torch.zeros((b,), dtype=I32, device=dev)
    for k in range(rings):
        unmatched = valid & ~matched
        # argmax returns the FIRST maximum; 0 (with unmatched[:, 0] False)
        # when nothing is left.
        first = torch.argmax(unmatched.to(torch.uint8), dim=1, keepdim=True)
        has = unmatched.gather(1, first)
        a = alpha.gather(1, first)
        angles[:, k:k + 1] = torch.where(has, a, inf)
        matched |= has & (torch.abs(alpha - a) <= tol)
        count += has[:, 0].to(I32)
    return torch.sort(angles, dim=-1).values, count


def discover_rings(alpha, valid, interval, rings: int = CHANNELS):
    """Greedy ring registration per scan (lidar_segmentation.cpp:168-197).
    alpha: (B, N) f32 vertical angles; valid: (B, N) bool ROI mask;
    interval: a 0-d float32 tensor on alpha's device, or a host scalar.
    Returns (ascending ring angles (B, rings) padded with +inf, NaN last,
    ring count (B,) int32).  On the card: one kernel launch over (segments,
    B) blocks, which sorts the table itself, after a memset of its B
    arrival counters (the scratch also holds B x ceil(N / 32) mask words).
    Nothing is read back to the host."""
    _check_rings(rings)
    if _build.on_cpu(alpha):
        return discover_rings_plain(alpha, valid, interval, rings)
    b, n = alpha.shape
    dev = alpha.device
    _build.check(alpha, "alpha", F32, (b, n), dev)
    _build.check(valid, "valid", torch.bool, (b, n), dev)
    angles = torch.empty((b, rings), dtype=F32, device=dev)
    count = torch.empty((b,), dtype=I32, device=dev)
    scratch = torch.empty((b * (1 + (n + 31) // 32),), dtype=I32, device=dev)
    tol = param_tensor(interval, dev)
    _launch("discover_rings", "urf_discover_rings", dev, _build.ptr(alpha),
            _build.ptr(valid), b, n, _build.ptr(tol), rings,
            _build.ptr(angles), _build.ptr(count), _build.ptr(scratch))
    return angles, count


def assign_rings_plain(alpha, valid, angles_sorted, interval):
    rings = angles_sorted.shape[-1]
    m = (torch.abs(angles_sorted[:, None, :] - alpha[:, :, None])
         <= param(interval))
    has = torch.any(m, dim=-1)
    ring = torch.argmax(m.to(torch.uint8), dim=-1).to(I32)
    return torch.where(valid & has, ring, torch.full_like(ring, rings))


def assign_rings(alpha, valid, angles_sorted, interval):
    """First matching ring in ascending-angle order per point
    (lidar_segmentation.cpp:226-233): (B, N) int32, ``rings`` (the table
    size) for a point outside the ROI or matching no ring.

    angles_sorted: (B, rings) as discover_rings returns it, ascending with
    +inf padding and NaN last.  The kernel bisects the table and relies on
    that order (the plain twin scans any table); a table of one scan
    expanded over B, as the SP path passes, meets it."""
    b, rings = angles_sorted.shape
    _check_rings(rings)
    if _build.on_cpu(alpha):
        return assign_rings_plain(alpha, valid, angles_sorted, interval)
    n = alpha.shape[1]
    dev = alpha.device
    _build.check(alpha, "alpha", F32, (b, n), dev)
    _build.check(valid, "valid", torch.bool, (b, n), dev)
    _build.check(angles_sorted, "angles_sorted", F32, (b, rings), dev)
    ring = torch.empty((b, n), dtype=I32, device=dev)
    tol = param_tensor(interval, dev)
    _launch("assign_rings", "urf_assign_rings", dev, _build.ptr(alpha),
            _build.ptr(valid), _build.ptr(angles_sorted), b, n, rings,
            _build.ptr(tol), _build.ptr(ring))
    return ring
