#!/usr/bin/env python3
"""Smoke run of the PyTorch port (urban_road_filter_torch) on one CUDA card.

    python3 chip_smoke.py

1. Builds the port's CUDA kernels from urban_road_filter_torch/csrc with
   nvcc (sm_90a) and prints the build time and the card's name and power
   limit.
2. Holds each of the 15 kernels (the list is _build.KERNELS: the 14 that
   replace TPU kernels and the ring geometry, which replaces the tensorize
   stage's glue) against its plain PyTorch twin on the card; every output
   must be bit-equal.  The
   batch ingest (K1 ingest_prep, with and without the star keys, K2
   discover_rings, K3 assign_rings) runs, timed, on the phase-4 batch (128
   planar scans of 131072 points, 64 rings), at B = 1 on one OS1-64 drive
   scan (as process_scan calls it), at the SP call's shape (the phase-5
   OS1-128 scan, 262144 points, 128 rings, K2 on valid0 & fits) and, K2
   and K3, on that OS1-64 scan reordered ring-major (K2's worst case),
   printing the grid of each launch; then on the inputs that stress K2's
   prefix/filter/finish design and K3's search: the ring cap (24) reached
   in the prefix, n < 4096 and n not a multiple of 32 or 4, one valid
   point at the last index, NaN angles inside and after the 4096-point
   prefix, points exactly tol from a ring and one ulp either side over 128
   rings, tol-exact, all-NaN and empty tables; on the batch's first 8
   scans as rows and as planes, on 2 merged multi-LiDAR scans (262144
   points, 128 rings), on an all-invalid scan and on a scan with a NaN
   vertical angle in the ROI.  K1 must be one device op on each (the
   launch zeroes its in-ROI counts itself).
   The per-scan kernels (K4 star search, K5 rank, K6 place, K7 x/z-zero,
   K8 + K9 flood fill, K10 markers, K11 gather+pack, K12 road mask, K13
   marker keys, K14 marker state, the ring geometry after K6, also in the
   SP path's form) run on one emulated OS1-64 scan (131072
   points, 64 rings x 4096 slots), and again at the two shapes phase 4
   gives them: a bench lane (64 rings x 2048 slots) and a merged
   multi-LiDAR scan (262144 points, 128 rings x 2048 slots).  At each
   shape K4 also runs with the beams merged 60 to one and with every beam
   point in one beam (buckets longer than its shared chunk), and is held
   against the plain walk of the beam-sorted streams (its plain version);
   K5 also on ids over 9, 65, 129, 1025 and 2049 groups; K6 also runs on
   the inputs of place_cases (strided x/y/z, capacity 64, capacity 1023
   with one and two fields) and K10 on those
   of marker_cases (ties across every row-block, every candidate past
   kf, num_rings 5, no counts), on the layout and again at capacity 1023;
   K9 and K12 on those of flood_cases (window widths 0 to inf and NaN,
   azimuths on and one ulp beside the window ends and the integer starts,
   reach bits all, none, alternating, only the special or the last start,
   two beam zones, num_rings 5) and K11 with probably_road_ring equal to
   the ring count (no point may be flagged).  K11 also over the phase-4
   batch as process_batch calls it (128 lanes in one launch, one device
   op), timed beside one indexed gather of the stacked tables.
   K7 in place (marks written into the table it is given, one device
   op, timed on one table: its marks ignore the label) and, returning a
   new table, at window sizes 3, 10 and 30; its bound counts the slots it
   must read and the marks it writes, printed with the byte formula.
   K8 also with every slot a curb (its worst case, timed).  The ring
   geometry timed at 64 x 4096 and on the bench lane (64 x 2048), its
   plain twin being the glue it replaced, its bound 16 B a slot written,
   8 B a placed slot read and 8 B a row (rg_bytes).  K7's SP entry (the
   stencils over every wedge's ring segments with their halo points, in
   place, one device op), the ring geometry as sp_tensorize and
   sort_by_azimuth call it, K8 and K14's two passes also at the SP path's
   stacked shape (8 wedges of 128 x 384 slots of the OS1-128 scan, one
   launch each over all wedges), timed.
   On the OS1-64 scan the unfused path (blind_spots(want_marker_f=False),
   K8 + K12, then marker_points(kf=None), K13 + K10) must equal the fused
   one bit for bit; K13 must be one device op a call (no fill).  Prints
   median CUDA-event times of kernel, twin and, where one PyTorch call
   computes the same function, that call; and each
   kernel's bound, the larger of its bytes over the HBM rate and its
   operations over the FP32 rate, from this run's inputs.
3. Drives the single-scan pipeline (packed_scan) on 9 full-size scans, the
   7 synthetic scenes at 64 rings x 2048 azimuths and 2 emulated OS1-64
   drive scans, in two configurations: the default (star search on) and
   star search off.  Launch counters are zeroed just before and read just
   after: every kernel of the path must have run.  Each result is gated
   against the numpy oracle (agreement >= 0.999, 0 systematic flips).
   Then two_curbs, blind_spot and curb_gap again with the x/z-zero
   stencils off, gated the same way (their star-hit curbs sit at the 2-D
   azimuth 60.0, where a flood window starts).
4. Drives the batch pipeline (process_batch, default configuration) on the
   replay benchmark's batch: 128 planar scans of 131072 points, 64 rings x
   2048 slots, two_curbs and blind_spot alternating (bench.py).  Launch
   counters as in phase 3; prints scans/s host to host (median of 3 runs,
   every output fetched).  K11 must launch once per 128 lanes of a batch,
   not once per lane.  Every lane must equal process_scan of its scan
   bit for bit, and no ring may overflow.  A second batch of the 7 scenes
   and 2 OS1-64 drive scans, with the star search on and off, and 4 lanes
   of the first, are gated against the oracle as in phase 3; so is one
   lane of a batch of 4 merged multi-LiDAR scans (262144 points, 128
   rings, bench.py's rig).
5. Drives the azimuth-sharded path (make_azimuth_pipeline, 8 wedges on the
   card) on two azimuth-sorted deployments: the emulated OS1-128 drive at
   262144 points, 128 rings x 2048 slots (32768 points and 128 x 384 slots
   per wedge), and the OS1-64 preset on an OS1-64 drive scan (64 x 768 per
   wedge), each with the star search on and off.  Launch counters as in
   phase 3.  Labels and markers must equal process_scan's of the same
   scan, or differ only at an integer degree (the count is printed); the
   oracle gate as in phase 3 (128 channels for the 128-ring scan); no
   overflow.  Prints the SP scan latency p50 host to host.  The SP runs
   here are the stages op by op (run.eager; phase 10 replays them).  Each
   SP scan must launch K7 and K8 once and K14 and the ring geometry
   twice.  K12 and K13 are held against their twins again at the
   per-wedge shapes, K7's SP entry, K8 and K14 over the stacked wedges,
   K14 with the run's own g_offset and f_init; the sp_xz_zero stage's
   device ops are printed (torch.profiler).
6. Drives the port's replay harness (io.replay.ReplayHarness) on the card:
   (a) the three recorded-style PCD fixtures of tests/fixtures (16384
   points, binary_compressed, NaN rows sent as they are), read by the
   native reader (which must have built; equal to the Python reader),
   replayed through pcd_dir_source: each scan ok, no overflow, no NaN row
   labelled, and the oracle gate as in phase 3; (b) 30 emulated OS1-64
   drive scans at 10 Hz in drop mode at depth 1, then flat out at depth
   2: no errors, no drops, the depth-2 outputs equal depth 1's field by
   field; latency p50 / p99, scans/s and drops printed; (c) SP mode (8
   wedges, the compiled SP run) on 3 OS1-128 drive scans: the topics
   equal those built from run.eager's results; (d) a bag of 3 drive scans
   written, read back bit-equal and replayed through bag_source.  Launch
   counters as in phase 3, per part.
7. Drives the modules of the last slice, each with the launch counters
   zeroed just before and read just after (K1-K11 must run): (a) checked
   mode (utils.checked.process_scan_checked) on phase 3's 9 scans x 2
   configurations, in turns with process_scan: every field bit-equal, the
   error word clean, both host-to-host p50s printed; then each index
   contract's predicate on a corrupted copy of one scan's index tensors
   sets its bit, on the clean ones none; (b) the harness in checked mode
   on the 3 PCD fixtures and 10 OS1-64 drive scans beside the default
   harness: 0 errors, the topics equal field by field, as many
   host-blocking CUDA calls a scan; (c) parallel.data_parallel.
   make_sharded_pipeline over [cuda:0] and [cuda:0, cuda:0] on phase 4's
   batch: every field equal to process_batch's; (d) one packed_scan under
   utils.profiling.device_trace: a trace file written, each launch of
   K1-K11 in its urf::k::<kernel> range inside its stage's urf::<stage>
   range on the host and on the device, the stages' device ms with their
   kernels printed, and SCAN_DEVICE_OPS device ops (the H2D and D2H of
   the outputs included), as before the ranges, in a fresh process; (e)
   examples/demo_torch.py at
   --render-every 0 on 4 scans with the beam_zone hot swap.
8. Drives the SP path over the ranks of a torch.distributed process group
   (make_azimuth_pipeline(8, ..., group=...)) on phase 5's two
   deployments, star search on and off, beside make_azimuth_pipeline(8)
   on one card in this call: (a) a one-rank NCCL group holding the 8
   wedges, in this process: its run compiled (one CUDA graph per key, the
   collectives inside) against run.eager, 10 pairs in turns after the
   capture, each of the 15 dynamic swaps and all at once, eager, compiled
   and a hot swap under torch.cuda.set_sync_debug_mode("error"), each
   graph's nodes, capture and instantiation ms and pool bytes, then the
   SP replay harness over the group (replaying); (b) 8 gloo ranks of one
   wedge each, spawned on cuda:0 (the JAX layout of one wedge per device;
   their run is run.eager, op by op, 1 + 5 runs), each reporting its
   launch counts, zeroed just before its timed runs and read just after
   (K1-K8, K12 and K14 on every rank), then K1 20 times a rank at once
   under the 8 contexts (its tickets), and the SP replay harness over the
   ranks (rank 0 replays 2 OS1-128 drive scans, the others follow); (c) on
   2 cards or more, NCCL over min(cards, 8) ranks (a power of two),
   compiled against run.eager as in (a), and the harness over them, else
   the line "phase 8 (c) not run: 1 card".  Every field of every rank and
   mode must be bit-equal to the one-card run, the census after every call
   eager's, one capture per key and none under the swaps where compiled,
   rank 0's results pass the oracle gate as in phase 5, the harness
   publishes the one-card SP harness's topics; a rank's failure or a rank
   that does not report within 300 s fails the run.  Prints the
   host-to-host SP p50s (one card; (a) compiled and op by op; (b)) and the
   collective census of a scan at the OS1-128 dims.
9. Drives the compiled entry points (pipeline.process_scan_jit,
   packed_scan_jit, process_batch_jit: a CUDA graph captured once per key
   and replayed, the dynamic parameters in a device buffer): phase 3's 9
   scans in every configuration, bit-equal to the eager entry points and
   gated; phase 4's batch; the replay harness (whose default path is
   packed_scan_jit) on the 3 PCD fixtures with the demo's beam_zone swap,
   no new capture and the eager harness's topics; each of the 15 dynamic
   fields swapped in turn and all at once on scan, packed and batch, no
   capture and the eager outputs under the new configuration (max_x=12
   changes the labels); a static swap, one capture; the launch counters
   credited per replay; phase 4's batch from pinned host memory (its copy
   in lane groups behind the compute) bit-equal to process_batch, each
   batch kernel launched once per lane group and LANE_GROUP_COPIES
   counting every call's groups; and, under
   torch.cuda.set_sync_debug_mode("error"), no synchronising call on the
   eager or compiled scan, packed and batch paths.  Prints each graph's nodes, capture and instantiation time and
   pool bytes.
10. Drives the compiled SP run (make_azimuth_pipeline(8) on the card: one
   CUDA graph of the whole SP run per key, replayed, the dynamic
   parameters in the entry's buffer) on phase 5's two deployments, star
   search on and off: (a) every replay bit-equal to run.eager on every
   field (planar too) and gated against the oracle; (b) each of the 15
   dynamic fields swapped in turn and all at once: no capture, every
   replay equal to run.eager under the new configuration, max_x=12
   changing the labels; a static swap, one capture; (c) eager, compiled
   and a hot swap under torch.cuda.set_sync_debug_mode("error"); (d) the
   launch counters zeroed just before 5 replays and read just after: K1,
   K2, K3, K8 and K7's SP entry once a scan, K4 and K12 once a wedge, K5,
   K6, K14 and the ring geometry twice; (e) each graph's nodes, capture
   and instantiation ms and pool bytes; (f) eager against compiled in
   turns on the OS1-128 scan: host enqueue and host-to-host p50, device
   busy and ops; (g) the harness in SP mode at 10 Hz on OS1-128 drive
   scans, compiled against eager in turns: latency p50 / p99, drops, dispatch / stage / fetch /
   post, and the same topics.
11. Prints one JSON line of per-kernel results (K1-K3 with their grid and
   their times at B = 1, "b1", at the SP call's shape, "sp", and, K2 and
   K3, on the ring-major scan, "ring_major"; K7's SP entry, "sp"; K11's
   over the phase-4 batch, "b128"; the ring geometry's on the bench lane,
   "64x2048") and, last,
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failure raises (exit code 1).  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPS = 50  # timed launches per kernel / twin (after 5 warm-up launches)
WALK_REPS = 5  # timed launches of the star search's plain version (one op
# per walk step)
SCAN_REPS = 5  # timed pipeline runs per scan (after 1 warm-up run)
BATCH_REPS = 3  # timed batch runs (after 1 warm-up run)
BATCH = 128  # scans in the phase-4 batch (bench.py's replay batch)
WEDGES = 8  # azimuth wedges of the phase-5 SP path
HBM_BYTES_S = 3.35e12  # H100 SXM memory rate (NVIDIA data sheet)
FP32_OPS_S = 67e12  # H100 SXM FP32 rate outside the tensor cores; integer
# and compare operations are counted at the same rate

# Kernels each path runs (launch-counter names, _build.KERNELS).
SCAN_KERNELS = ("ingest_prep", "discover_rings", "assign_rings", "star_walk",
                "group_rank", "group_place", "ring_geometry", "xz_zero",
                "flood_blocked", "flood_labeled", "marker_points",
                "gather_pack")
UNFUSED_KERNELS = ("flood_blocked", "flood_road", "marker_first_nonroad",
                   "marker_points")
SP_KERNELS = ("ingest_prep", "discover_rings", "assign_rings", "star_walk",
              "group_rank", "group_place", "ring_geometry", "xz_zero",
              "flood_blocked", "flood_road", "marker_state")


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: bytes (each input read once,
    each output written once) over the HBM rate, or operations over the
    FP32 rate, whichever is larger."""
    tb, to = nbytes / HBM_BYTES_S, ops / FP32_OPS_S
    return {"bound_ms": max(tb, to) * 1e3,
            "bound_by": "bytes" if tb >= to else "operations"}


def assert_launched(launches: dict, names, what: str) -> None:
    missing = [k for k in names if launches.get(k, 0) <= 0]
    assert not missing, f"kernels not launched by {what}: {missing}"


def assert_no_jax() -> None:
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "urban_road_filter_tpu")]
    assert not bad, f"the port must run without JAX: {bad[:5]}"


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median device time of one call of fn, in ms (CUDA events)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profiled_ops(fn) -> int:
    """Device ops (kernels, copies, memsets) of one call of fn as
    torch.profiler sees them: for code untried in a CUDA-graph capture
    (the SP halo exchange makes a tensor from a host value)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def max_abs_err(got, want) -> float:
    """Max |got - want| over paired outputs; raises unless bit-equal (float
    outputs compare by their bits, so NaNs must match too)."""
    err = 0.0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype)
        assert g.device.type == "cuda"
        if g.dtype == torch.float32:
            same = torch.equal(g.view(torch.int32), w.view(torch.int32))
        else:
            same = torch.equal(g, w)
        assert same, "kernel and plain twin disagree"
        if g.numel():
            d = torch.where(g == w, 0.0, (g.double() - w.double()).abs())
            err = max(err, float(torch.nan_to_num(d, nan=0.0).max()))
    return err


def bench_scans(count: int):
    """bench.py's batch: two_curbs and blind_spot alternating, 64 rings x
    2048 azimuths, seed = lane."""
    from urban_road_filter_torch.io import SCENES, make_scan

    return [make_scan(SCENES["two_curbs" if i % 2 == 0 else "blind_spot"](),
                      n_rings=64, n_azimuth=2048, seed=i)
            for i in range(count)]


def multi_lidar_scans():
    """bench.py's merged multi-LiDAR rig: two emulated OS1-64 at offset
    mounts, 2048 firings each, 262144 points; 4 scenes."""
    from urban_road_filter_torch.io import (
        Extrinsics, SceneSpec, make_sensor_scan, merge_scans)

    exts = [Extrinsics(x=0.4, y=0.3, z=0.0, yaw_deg=1.5),
            Extrinsics(x=-0.4, y=-0.3, z=-0.05, yaw_deg=-2.0)]
    specs = [SceneSpec(curb_right_y=3.3 + 0.2 * i,
                       curb_left_y=-3.4 + 0.15 * i,
                       curb_height=0.15 + 0.02 * i,
                       vehicles=((12.0 + 3.0 * i, 2.3, 2.2, 0.85, 1.5),),
                       vegetation=((8.0 + 2.0 * i, -5.0 - 0.5 * i,
                                    -1.2, 1.2),))
             for i in range(4)]
    return [merge_scans([make_sensor_scan(sp, "os1_64", seed=70 + 2 * i,
                                          firings=2048),
                         make_sensor_scan(sp, "os1_64", seed=71 + 2 * i,
                                          firings=2048)], exts)
            for i, sp in enumerate(specs)]


def rings_vs_twins(alpha, valid, interval, rings):
    """K2 and K3 on (B, N) vertical angles and ROI mask against their
    twins, bit-equal.  Returns ({kernel: (kernel call, twin call, max abs
    error, bound)}, angles, count).  The bounds count alpha and valid read
    and the table written (K2, K3) and the ring ids written (K3); K2's
    operations at 3 per ring test, each valid point tested against half of
    its scan's table, K3's at 3 per test up to its first match."""
    from urban_road_filter_torch.ops import ingest

    k2 = lambda: ingest.discover_rings(alpha, valid, interval, rings)
    p2 = lambda: ingest.discover_rings_plain(alpha, valid, interval, rings)
    angles, count = k2()
    e2 = max_abs_err((angles, count), p2())
    k3 = lambda: ingest.assign_rings(alpha, valid, angles, interval)
    p3 = lambda: ingest.assign_rings_plain(alpha, valid, angles, interval)
    ring = k3()
    e3 = max_abs_err((ring,), (p3(),))
    b, n = alpha.shape
    n_valid = valid.sum(1).double()
    tests = torch.where(valid, torch.minimum(ring, count[:, None] - 1) + 1,
                        0).sum().item()
    calls = {"discover_rings": (k2, p2, e2, bound(
                 b * n * 5 + b * rings * 4 + 4 * b,
                 1.5 * float((n_valid * count.double()).sum()))),
             "assign_rings": (k3, p3, e3, bound(b * n * 9 + b * rings * 4,
                                                3 * tests))}
    return calls, angles, count


def ingest_vs_twins(x, y, z, cfg, rings):
    """K1-K3 on (B, N) coordinate views against their twins, bit-equal.
    Returns {kernel: (kernel call, twin call, max abs error, bound)} and
    the ring counts.  K1's bound counts x, y, z read and valid, fk, r_key
    written, and ~40 operations per point (a float64 atan2, a root, the
    ROI compares)."""
    from urban_road_filter_torch import _build
    from urban_road_filter_torch.ops import geometry, ingest

    k1 = lambda: ingest.ingest_prep(x, y, z, cfg)
    p1 = lambda: ingest.ingest_prep_plain(x, y, z, cfg)
    prep = k1()
    e1 = max_abs_err(prep, p1())
    valid = prep[0]
    ops = _build.device_ops(k1)
    assert ops == 1, f"K1 must be one device op (no fill): {ops}"
    # Without the star keys (the star search off) only valid and piece.
    lean = ingest.ingest_prep(x, y, z, cfg, want_star_keys=False)
    assert lean[1] is None and lean[2] is None
    max_abs_err(lean[::3], ingest.ingest_prep_plain(
        x, y, z, cfg, want_star_keys=False)[::3])
    _, alpha = geometry.vertical_angles(x, y, z)
    calls, _, count = rings_vs_twins(alpha, valid, cfg.interval, rings)
    b, n = x.shape
    calls = {"ingest_prep": (k1, p1, e1, bound(b * n * 21 + 4 * b,
                                               40 * b * n)), **calls}
    return calls, count


def time_calls(calls, what):
    """CUDA-event times of each (kernel, twin) pair, with the bound and the
    grid the kernel's launches used."""
    from urban_road_filter_torch.ops import ingest

    out = {}
    for name, (kernel, plain, err, bnd) in calls.items():
        ms = cuda_ms(kernel)
        grid = list(ingest.last_grid[name])
        out[name] = {"max_abs_err": err, "ms": ms,
                     "plain_ms": cuda_ms(plain, WALK_REPS), **bnd,
                     "library_ms": None, "grid": grid}
        print(f"  {name} ({what}): bit-equal, grid {grid}, kernel {ms:.4f} "
              f"ms, plain {out[name]['plain_ms']:.4f} ms, bound "
              f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})", flush=True)
    return out


def os1_64_scan():
    """One emulated OS1-64 drive scan (make_drive seed 41): 1024 firings of
    64 beams, 65536 returns, azimuth-major as the sensor emits them."""
    from urban_road_filter_torch.io import make_drive

    return next(make_drive(1, sensor="os1_64", seed=41))


def ring_major(scan, beams=64):
    """The scan's points reordered beam by beam: K2's worst case, whose
    first 4096 points hold about two rings."""
    c = scan.shape[1]
    return np.ascontiguousarray(
        scan.reshape(-1, beams, c).transpose(1, 0, 2).reshape(-1, c))


def sp_ring_inputs(dev, cfg, host):
    """K1-K3's inputs on the SP path of phase 5's OS1-128 scan ((N, 4)
    padded rows on the host), as make_azimuth_pipeline(8) makes them: the
    (1, N) coordinate views (K1); the vertical angles and valid0 & fits,
    the points that fit their wedge (K2, and K3 here on the same points in
    input order, where the SP call takes them as 8 wedges of N / 8)."""
    from urban_road_filter_torch.ops import geometry, ingest
    from urban_road_filter_torch.ops.rank import group_positions
    from urban_road_filter_torch.parallel.azimuth_parallel import wedge_of

    pts = torch.from_numpy(host).to(dev)
    x, y, z, _ = geometry.xyz_of(pts, "rows")
    valid0, fk0, _, _ = ingest.ingest_prep(x[None], y[None], z[None], cfg)
    wedge = wedge_of(fk0[0], valid0[0], WEDGES)
    wpos, _ = group_positions(wedge, WEDGES + 1)
    fits = (wedge < WEDGES) & (wpos < pts.shape[0] // WEDGES)
    _, alpha = geometry.vertical_angles(x, y, z)
    return (x[None], y[None], z[None]), alpha[None], (valid0[0] & fits)[None]


def ring_edges(dev, cfg, scan_rows):
    """K2 and K3 against their twins on the inputs that stress their
    designs (csrc/ingest.cu), on one 131072-point OS1-64 scan (rows on the
    card): prefix, filter and finish at the cap, at ragged lengths, with
    NaN angles inside and after the 4096-point prefix, with one valid point
    at the end; tables with entries exactly tol away from points and one
    ulp either side, all-NaN and empty tables."""
    from urban_road_filter_torch.ops import geometry, ingest

    x, y, z, _ = geometry.xyz_of(scan_rows, "rows")
    valid = geometry.roi_mask_xyz(x, y, z, cfg)[None]
    _, alpha = geometry.vertical_angles(x, y, z)
    alpha = alpha[None].contiguous()
    n = alpha.shape[1]
    tol = cfg.interval
    _, _, count = rings_vs_twins(alpha, valid, tol, 24)
    assert int(count[0]) == 24  # the cap, reached in the prefix
    for m in (1000, n - 3):  # n < 4096; n not a multiple of 32 or 4
        rings_vs_twins(alpha[:, :m].contiguous(), valid[:, :m].contiguous(),
                       tol, 64)
    last = torch.zeros_like(valid)
    last[0, -1] = True
    a_last = alpha.clone()
    a_last[0, -1] = alpha[0, 0]  # a padding row's angle is NaN
    _, _, count = rings_vs_twins(a_last, last, tol, 64)
    assert int(count[0]) == 1
    nan_rows = scan_rows[None].repeat(3, 1, 1)
    for b, where in enumerate(((5,), (70000,), (5, 70000))):
        for i in where:
            nan_rows[b, i, :3] = torch.tensor([1e-25, 0.0, 0.0], device=dev)
    nx, ny, nz, _ = geometry.xyz_of(nan_rows, "rows", batched=True)
    _, count = ingest_vs_twins(nx, ny, nz, cfg.replace(max_z=1.0), 64)
    assert (count == 64).all()
    # Points exactly tol from a ring and one ulp either side, 128 rings.
    t32 = np.float32(tol)
    centres = np.linspace(-20.0, 20.0, 97).astype(np.float32)
    edges = np.concatenate([centres + t32, centres - t32]).astype(np.float32)
    stream = np.resize(np.concatenate(
        [centres, edges, np.nextafter(edges, np.inf),
         np.nextafter(edges, -np.inf)]).astype(np.float32), n)
    a_tol = torch.from_numpy(stream).to(dev)[None]
    v_tol = torch.ones_like(a_tol, dtype=torch.bool)
    rings_vs_twins(a_tol, v_tol, tol, 128)
    tables = [torch.full((1, 128), float("inf"), device=dev),
              torch.full((1, 128), float("nan"), device=dev)]
    tables[0][0, :97] = torch.from_numpy(centres).to(dev)
    for table in tables + [tables[0][:, 97:]]:
        for a, v in ((a_tol, v_tol), (alpha, valid)):
            got = ingest.assign_rings(a, v, table, tol)
            max_abs_err((got,), (ingest.assign_rings_plain(a, v, table,
                                                           tol),))
    print("  K2/K3 edges: cap 24, n = 1000 and n - 3, one valid point at "
          "the end, NaN angles at 5 / 70000 / both, tol-exact and 1-ulp "
          "points over 128 rings, tol-exact, all-NaN and empty tables: "
          "bit-equal", flush=True)


def phase_ingest(dev, cfg, planar, mrows):
    """K1-K3 against their twins.  planar: the phase-4 batch (3, 128, N)
    on the card; mrows: merged multi-LiDAR scans (B, 262144, 4) on the
    card.  Returns the per-kernel results timed at the phase-4 shapes, with
    the times at B = 1 ("b1": one OS1-64 scan, as process_scan calls them)
    and at the SP call's shape ("sp"), and K2's on the ring-major scan."""
    from urban_road_filter_torch import PipelineDims, pad_scan
    from urban_road_filter_torch.ops import geometry

    x, y, z, _ = geometry.xyz_of(planar, "planar", batched=True)
    calls, count = ingest_vs_twins(x, y, z, cfg, 64)
    assert int(count.min()) > 20, "every scan must have rings"
    out = time_calls(calls, f"B={x.shape[0]}, N={x.shape[1]}")

    n = PipelineDims.for_sensor("os1-64").max_points
    scan = torch.from_numpy(pad_scan(os1_64_scan(), n)).to(dev)
    sx, sy, sz, _ = geometry.xyz_of(scan, "rows")
    calls, count = ingest_vs_twins(sx[None], sy[None], sz[None], cfg, 64)
    assert int(count[0]) > 20
    for name, res in time_calls(calls, f"B=1, N={n}, OS1-64 scan").items():
        out[name]["b1"] = res

    _, sp_dims, sp_scan, _ = sp_deployments()[0]
    xyz, alpha, ring_valid = sp_ring_inputs(
        dev, cfg, pad_scan(sp_scan, sp_dims.max_points))
    calls, _ = ingest_vs_twins(*xyz, cfg, sp_dims.rings)
    sp = {"ingest_prep": calls["ingest_prep"]}
    sp.update(rings_vs_twins(alpha, ring_valid, cfg.interval,
                             sp_dims.rings)[0])
    for name, res in time_calls(sp, f"SP call, B=1, N={alpha.shape[1]}, "
                                f"{sp_dims.rings} rings").items():
        out[name]["sp"] = res

    rm = torch.from_numpy(pad_scan(ring_major(os1_64_scan()), n)).to(dev)
    rx, ry, rz, _ = geometry.xyz_of(rm, "rows")
    valid = geometry.roi_mask_xyz(rx, ry, rz, cfg)[None]
    _, alpha = geometry.vertical_angles(rx, ry, rz)
    calls, _, count = rings_vs_twins(alpha[None].contiguous(), valid,
                                     cfg.interval, 64)
    assert int(count[0]) > 20
    for name, res in time_calls(calls, "ring-major OS1-64 scan").items():
        out[name]["ring_major"] = res
    ring_edges(dev, cfg, scan)

    rows = planar[:, :8].permute(1, 2, 0).contiguous()
    for layout, pts in (("rows", rows), ("planar", planar[:, :8])):
        ingest_vs_twins(*geometry.xyz_of(pts, layout, batched=True)[:3], cfg,
                        64)
    print("  (8, 131072) rows and planar: bit-equal", flush=True)

    mx, my, mz, _ = geometry.xyz_of(mrows[:2], "rows", batched=True)
    calls, count = ingest_vs_twins(mx, my, mz, cfg, 128)
    assert int(count.min()) > 64, "the merged rig must have > 64 rings"
    time_calls(calls, "B=2, N=262144, 128 rings")

    empty = rows[:2].clone()
    empty[1] = 0
    _, count = ingest_vs_twins(*geometry.xyz_of(empty, "rows",
                                                batched=True)[:3], cfg, 64)
    assert int(count[1]) == 0
    # A point in the ROI whose vertical angle is NaN (x*x + y*y + z*z
    # underflows) is a ring in every round after it, as in the oracle.
    odd = rows[:1].clone()
    odd[0, 5] = torch.tensor([1e-25, 0.0, 0.0], device=dev)
    _, count = ingest_vs_twins(*geometry.xyz_of(odd, "rows",
                                                batched=True)[:3],
                               cfg.replace(max_z=1.0), 64)
    assert int(count[0]) == 64
    print("  all-invalid scan and NaN vertical angle: bit-equal", flush=True)
    return out


def place_cases(pts, ring_id, pos, rings, cap):
    """(name, fields, capacity) of K6's inputs that stress its design
    (csrc/group_place.cu): the scan's rows-layout x/y/z views (element
    stride 4, as packed_scan gives them) at its capacity; capacity 64
    (rings overflow: points dropped and counted from the group totals);
    capacity 1023 (P % 4 != 0: rows straddle 16-byte quads) with one
    field and with two, the second NaN on every dropped point."""
    from urban_road_filter_torch.ops import geometry

    x, y, z, _ = geometry.xyz_of(pts, "rows")
    nan_x = torch.where((ring_id >= rings) | (pos >= 1023), float("nan"), x)
    return [("strided x/y/z", (x, y, z), cap),
            ("capacity 64", (x, y, z), 64),
            ("capacity 1023, one field", (z,), 1023),
            ("capacity 1023, two fields", (y, nan_x), 1023)]


def marker_cases(road, num_rings, kf):
    """(name, layout, num_rings, kf) of K10's inputs that stress its design
    (csrc/markers.cu): the flooded layout; every valid slot road at one
    distance and no kf ("ties": each bin's max is tied across all rings and
    row-blocks, and the smallest key must win); the same with kf at each
    bin's smallest key ("past kf": no candidate anywhere); num_rings 5; no
    counts."""
    from urban_road_filter_torch.ops import markers as mk

    r, p = road.alpha.shape
    valid = (torch.arange(p, device=road.alpha.device)[None, :]
             < road.counts[:, None])
    ties = road._replace(label=torch.where(valid, 1, road.label),
                         d2=torch.where(valid, 7.0, road.d2))
    first = mk.first_nonroad_keys(
        road._replace(label=torch.zeros_like(road.label)), num_rings)
    return [("flooded", road, num_rings, kf),
            ("ties", ties, num_rings, torch.full_like(kf, mk.NO_KEY)),
            ("past kf", ties, num_rings, first),
            ("5 rings", road, torch.full_like(num_rings, 5), kf),
            ("no counts", road._replace(counts=torch.zeros_like(
                road.counts)), num_rings, kf)]


FLOOD_W = (0.0, 1e-30, 1.0, 37.5, 361.0, 1e30, float("inf"), float("nan"))


def flood_cases(layout, num_rings):
    """(name, layout, reach_f, reach_b, w, beam zone, num_rings) of K9's and
    K12's inputs that stress their design (csrc/flood.cu: the interval of
    covering starts, its two bisections, the special starts), at the
    layout's shape, made from a seed: window widths cycling through 0,
    1e-30, 1, 37.5, 361, 1e30, inf and NaN over the rings; azimuths at
    integer starts, at fl(i + w) and fl(i - w) and one ulp either side,
    -0.0, 360.0, NaN, just outside [0, 360] and uniform; counts from 0 to
    the capacity; labels 0-2.  The reach bits all set, none, alternating,
    only the special starts (the starts at 360 - bz and bz), only start 361
    and random, each at a beam zone where 360 - bz and bz are integers (30)
    and one where they are not (45.5); then with num_rings 5."""
    dev = layout.alpha.device
    r, p = layout.alpha.shape
    f32 = np.float32
    rng = np.random.default_rng(11)
    w = np.array([FLOOD_W[k % len(FLOOD_W)] for k in range(r)], f32)
    start = rng.integers(0, 362, (r, p)).astype(f32)
    with np.errstate(invalid="ignore", over="ignore"):
        fwd, bwd = start + w[:, None], start - w[:, None]
    odd = rng.choice(np.array([-0.0, 360.0, np.nan, -1e-3,
                               np.nextafter(f32(360), f32(400))], f32),
                     (r, p))
    choices = [start, fwd, np.nextafter(fwd, f32(np.inf)),
               np.nextafter(fwd, f32(-np.inf)), bwd,
               np.nextafter(bwd, f32(np.inf)),
               np.nextafter(bwd, f32(-np.inf)), odd,
               rng.uniform(0.0, 360.0, (r, p)).astype(f32)]
    alpha = np.choose(rng.integers(0, len(choices), (r, p)), choices)
    counts = rng.integers(0, p + 1, r).astype(np.int32)
    counts[:2] = p
    label = rng.integers(0, 3, (r, p)).astype(np.int32)
    lay = layout._replace(alpha=torch.from_numpy(alpha.astype(f32)).to(dev),
                          label=torch.from_numpy(label).to(dev),
                          counts=torch.from_numpy(counts).to(dev))
    wt = torch.from_numpy(w).to(dev)
    i = np.arange(362)
    cases = []
    for bz in (30.0, 45.5):
        only = lambda at: np.broadcast_to(i == at, (r, 362))
        patterns = {
            "all": (np.ones((r, 362), bool),) * 2,
            "none": (np.zeros((r, 362), bool),) * 2,
            "alternating": ((i[None] + np.arange(r)[:, None]) % 2 == 0,
                            (i[None] + np.arange(r)[:, None]) % 2 == 1),
            "special only": (only(int(360 - bz)), only(int(bz))),
            "only 361": (only(361),) * 2,
            "random": tuple(rng.random((2, r, 362)) < 0.3)}
        for name, (rf, rb) in patterns.items():
            cases.append((f"{name}, bz {bz}", lay,
                          torch.from_numpy(np.ascontiguousarray(rf)).to(dev),
                          torch.from_numpy(np.ascontiguousarray(rb)).to(dev),
                          wt, bz, num_rings))
    cases.append(("random, num_rings 5", *cases[-1][1:6],
                  torch.full_like(num_rings, 5)))
    return cases


def rank_ids(n, groups, seed=3):
    """(n,) int32 group ids in [0, groups), made from a seed, in runs of
    random length as rings of an azimuth-major scan give them."""
    rng = np.random.default_rng(seed + groups)
    runs = rng.integers(1, 40, n)
    return np.repeat(rng.integers(0, groups, n), runs)[:n].astype(np.int32)


def star_chain_steps(fk, r_key, z, hp) -> int:
    """The longest walk of the star search, in steps: per beam the position
    of its triggering point in the beam's radius order, or the beam's
    length where nothing trips."""
    from urban_road_filter_torch.ops import star

    fk_s, _, _, pid = star.beam_order(fk, r_key, z)
    beam = fk_s.long()
    inb = beam < 360
    length = torch.bincount(beam[inb], minlength=360)
    start = torch.cumsum(length, 0) - length
    steps = length.clone()
    hit = torch.nonzero(hp > 0).flatten()
    at = torch.nonzero(torch.isin(pid, (hp[hit] - 1).to(pid.dtype))).flatten()
    steps[beam[at]] = at - start[beam[at]]
    return int(steps.max())


def rg_bytes(counts, p: int, fills: bool = True) -> int:
    """The least bytes of one ring geometry launch over the rows of
    ``counts`` at p slots a row: d2 and alpha (and, with ``fills``, label
    and pid) written for every slot, x and y read for the slots below
    counts, counts read and the max written."""
    rows = counts.numel()
    placed = int(torch.clamp(counts, 0, p).sum())
    return (16 if fills else 8) * rows * p + 8 * placed + 8 * rows


def phase_kernels(dev, dims, cfg, scan, what, timed=True):
    """Each per-scan kernel against its plain twin on one scan (a (M, >=3)
    host array) padded to dims, and the unfused flood/marker path against
    the fused one.  Timed (True, or a set of the kernels to time), the
    CUDA-event times of kernel, twin and library call are taken and
    returned with each kernel's bound."""
    from urban_road_filter_torch import _build, launch_counts, pad_scan
    from urban_road_filter_torch import reset_launch_counts
    from urban_road_filter_torch.ops import blind_spots as bs
    from urban_road_filter_torch.ops import geometry, ingest
    from urban_road_filter_torch.ops import markers as mk
    from urban_road_filter_torch.ops import star
    from urban_road_filter_torch.ops.gather import (
        gather_pack, gather_pack_plain)
    from urban_road_filter_torch.ops.marker_state import (
        marker_state, marker_state_plain)
    from urban_road_filter_torch.ops.place import (
        group_place, group_place_plain)
    from urban_road_filter_torch.ops.rank import (
        group_positions, group_positions_plain)
    from urban_road_filter_torch.ops.stencil_kernels import (
        fused_xz_zero, fused_xz_zero_, xz_zero_plain)

    r, p, n = dims.rings, dims.ring_capacity, dims.max_points
    print(f"  {what}: N={n}, {r} rings x {p} slots", flush=True)
    pts = torch.from_numpy(pad_scan(scan, n)).to(dev)
    x, y, z, _ = geometry.xyz_of(pts, "rows")
    x, y, z = x.contiguous(), y.contiguous(), z.contiguous()
    valid = geometry.roi_mask_xyz(x, y, z, cfg)
    _, alpha = geometry.vertical_angles(x, y, z)
    angles, num_rings = geometry.discover_rings(alpha, valid, cfg.interval,
                                                rings=r)
    ring_id = geometry.assign_rings(alpha, valid, angles, cfg.interval)
    out = {}

    def record(name, got, want, kernel, plain, plain_reps=REPS, nbytes=0,
               ops=0, library=None):
        out[name] = {"max_abs_err": max_abs_err(got, want)}
        if timed is not True and name not in (timed or ()):
            print(f"    {name}: bit-equal", flush=True)
            return
        out[name].update(ms=cuda_ms(kernel),
                         plain_ms=cuda_ms(plain, plain_reps),
                         **bound(nbytes, ops),
                         library_ms=None if library is None
                         else cuda_ms(library))
        lib = out[name]["library_ms"]
        print(f"    {name}: bit-equal, kernel {out[name]['ms']:.4f} ms, "
              f"plain {out[name]['plain_ms']:.4f} ms, bound "
              f"{out[name]['bound_ms']:.4f} ms ({out[name]['bound_by']}), "
              f"library {'none' if lib is None else f'{lib:.4f} ms'}",
              flush=True)

    # K4: the star search from the unsorted K1 keys, z a strided rows
    # view as packed_scan gives it; also with the beams merged 60 to one
    # and with every beam point in one beam, so that buckets outgrow the
    # kernel's shared chunk.  The bound counts fk and r_key read, z read
    # for the beam points and hp written, and ~20 operations per beam point
    # and 4 per point.  Printed beside it, not in the kernels line: an
    # estimate of the walk's chain, the longest walk in steps (the plain
    # walk's trip position, or the beam's length) times ~16 dependent
    # cycles per step at the H100's 1.98 GHz boost clock.
    _, fk1, rk1, _ = ingest.ingest_prep(x[None], y[None], z[None], cfg)
    fk, rk, zs = fk1[0], rk1[0], pts[:, 2]
    for case in (torch.where(fk < 360, fk // 60, fk),
                 torch.where(fk < 360, 7, fk)):
        got = star.star_search(case, rk, zs, cfg)
        max_abs_err((got,), (star.star_search_plain(case, rk, zs, cfg),))
        assert int((got > 0).sum()) > 0
    k4 = lambda: star.star_search(fk, rk, zs, cfg)
    p4 = lambda: star.star_search_plain(fk, rk, zs, cfg)
    hits = k4()
    assert int((hits > 0).sum()) > 30, "the scan must trigger star hits"
    nb = int((fk < 360).sum())
    record("star_walk", (hits,), (p4(),), k4, p4, WALK_REPS,
           nbytes=8 * n + 4 * nb + 360 * 4, ops=20 * nb + 4 * n)
    if timed:
        steps = star_chain_steps(fk, rk, zs, hits)
        print(f"    star_walk chain: longest walk {steps} steps x ~16 "
              f"dependent cycles at 1.98 GHz = "
              f"{steps * 16 / 1.98e9 * 1e3:.4f} ms (an estimate, not "
              f"measured)", flush=True)

    # K5: stable rank within ring, rings + 1 groups; then random ids over
    # 9, 65, 129, 1025 and 2049 groups (the SP path's 8 and 16 wedges x
    # 128 rings + 1), in runs as azimuth-major scans give them.
    for groups in (9, 65, 129, 1025, 2049):
        ids = torch.from_numpy(rank_ids(n, groups)).to(dev)
        max_abs_err(group_positions(ids, groups),
                    group_positions_plain(ids, groups))
    print("    group_rank at 9, 65, 129, 1025 and 2049 groups: bit-equal",
          flush=True)
    k5 = lambda: group_positions(ring_id, r + 1)
    p5 = lambda: group_positions_plain(ring_id, r + 1)
    pos, counts = k5()
    record("group_rank", (pos, counts), p5(), k5, p5,
           nbytes=8 * n + 4 * (r + 1), ops=4 * n)

    # K6: placement into (rings, slots), given K5's group totals; also on
    # the inputs of place_cases.  The library call: index_put_ of the
    # stacked x/y/z into a buffer with a dump ring and a dump slot (with
    # the clamps and the stack it needs).
    k6 = lambda: group_place(ring_id, pos, counts, (x, y, z), r, p)
    p6 = lambda: group_place_plain(ring_id, pos, counts, (x, y, z), r, p)
    cases = place_cases(pts, ring_id, pos, r, p)
    for case, fields, cap in cases:
        got = group_place(ring_id, pos, counts, fields, r, cap)
        max_abs_err(got, group_place_plain(ring_id, pos, counts, fields, r,
                                           cap))
        if cap == 64:
            assert int(got[-1]) > 0, "the capacity-64 case must overflow"
    print(f"    group_place on {[c for c, _, _ in cases]}: bit-equal",
          flush=True)

    def l6():
        buf = torch.zeros((r + 1, p + 1, 3), dtype=torch.float32, device=dev)
        return buf.index_put_((torch.clamp(ring_id, max=r).long(),
                               torch.clamp(pos, max=p).long()),
                              torch.stack([x, y, z], 1))

    record("group_place", k6(), p6(), k6, p6,
           nbytes=20 * n + 4 * (r + 1) + 12 * r * p + 4, ops=2 * n,
           library=l6)

    # The ring geometry after K6: d2, alpha, the label and pid planes and
    # each ring's max radius; untimed also the SP path's form (d2, alpha
    # and the max).  Its plain twin is the glue it replaced.  The bound:
    # rg_bytes.
    lx, ly, _, _ = k6()
    cnt = torch.clamp(counts[:r], max=p)
    kg = lambda: geometry.ring_geometry(lx, ly, cnt)
    pg = lambda: geometry.ring_geometry_plain(lx, ly, cnt)
    max_abs_err(*(tuple(t for t in g if t is not None) for g in (
        geometry.ring_geometry(lx, ly, cnt, False),
        geometry.ring_geometry_plain(lx, ly, cnt, False))))
    record("ring_geometry", kg(), pg(), kg, pg, nbytes=rg_bytes(cnt, p))

    # K7: both stencils on the placed layout, at window sizes 3, 10 and 30
    # (the returning form) and 5, in place on one table: the marks ignore
    # the label, so the timed launches rewrite the same marks.  The bound
    # counts x/y/z of the slots below counts read once, counts read and
    # each mark written once.
    layout, _, _ = geometry.tensorize(x, y, z, ring_id, p, rings=r)
    for cp in (3, 10, 30):
        c = cfg.replace(curb_points=cp)
        max_abs_err((fused_xz_zero(layout, c).label,),
                    (xz_zero_plain(layout, c).label,))
    marked = layout.label.clone()
    k7 = lambda: fused_xz_zero_(layout._replace(label=marked), cfg)
    p7 = lambda: xz_zero_plain(layout, cfg).label
    ops7 = _build.device_ops(k7)
    assert ops7 == 1, f"K7 must be one device op: {ops7}"
    n_marks = int((marked == 2).sum())
    assert n_marks > 0, "the scan must trigger curb marks"
    counted = int(torch.clamp(layout.counts, 0, p).sum())
    nbytes7 = 12 * counted + 4 * r + 4 * n_marks
    if timed:
        print(f"    xz_zero bound: 12 B x {counted} slots below counts + 4 B "
              f"x {r} counts + 4 B x {n_marks} marks = {nbytes7} B (every "
              f"slot: {20 * r * p + 4 * r} B)", flush=True)
    record("xz_zero", (marked,), (p7(),), k7, p7,
           nbytes=nbytes7, ops=(60 + 8 * int(cfg.curb_points)) * counted)
    out["xz_zero"]["device_ops"] = ops7

    # K8: the flood fill's blocked bits on the stenciled layout.
    stenciled = layout._replace(label=marked)
    slot_ok = torch.arange(p, device=dev)[None, :] < layout.counts[:, None]
    n_curb = int((slot_ok & (marked == 2)).sum())
    a_ok = slot_ok & (layout.alpha >= 0) & (layout.alpha <= 360)
    n_aok = int(a_ok.sum())
    bz = cfg.beam_zone
    w = bs.window_widths(geometry.max_distance(layout), bz)
    k8 = lambda: bs.flood_blocked(stenciled, w, bz)
    p8 = lambda: bs.flood_blocked_plain(stenciled, w, bz)
    blocked = k8()
    assert bool(blocked[0].any()), "the curbs must block some windows"
    # The bound counts alpha and label of the counted slots read once.
    record("flood_blocked", blocked, p8(), k8, p8,
           nbytes=8 * counted + 8 * r + 2 * r * 362,
           ops=4 * n_curb + 2 * 362 * r * 20)
    # K8's worst case: every slot of every ring a curb.
    curbs = stenciled._replace(label=torch.full_like(marked, 2))
    k8c = lambda: bs.flood_blocked(curbs, w, bz)
    max_abs_err(k8c(), bs.flood_blocked_plain(curbs, w, bz))
    if timed:
        print(f"    flood_blocked with every slot a curb: bit-equal, kernel "
              f"{cuda_ms(k8c):.4f} ms", flush=True)

    # K9: the road mask and the markers' first-pass keys.  K9's and K12's
    # operations: per valid slot two 9-step bisections (an f32 add and a
    # compare each) and the reach-bit counts, ~48.
    reach = bs.sweep_reach(stenciled, blocked, w, num_rings, cfg)
    k9 = lambda: bs.flood_labeled(stenciled, *reach, w, bz, num_rings)
    p9 = lambda: bs.flood_labeled_plain(stenciled, *reach, w, bz, num_rings)
    flooded, kf = k9()
    assert int((flooded == 1).sum()) > 0, "the flood must reach road"
    record("flood_labeled", (flooded, kf), p9(), k9, p9,
           nbytes=12 * r * p + 2 * r * 362 + 8 * r + 361 * 8,
           ops=48 * n_aok)

    # K12: the road mask alone.
    k12 = lambda: bs.flood_road(stenciled, *reach, w, bz)
    p12 = lambda: bs.flood_road_plain(stenciled, *reach, w, bz)
    road_mask = k12()
    record("flood_road", (road_mask,), (p12(),), k12, p12,
           nbytes=5 * r * p + 2 * r * 362 + 8 * r, ops=48 * n_aok)
    # K9 and K12 again on the inputs of flood_cases.
    cases = flood_cases(stenciled, num_rings)
    for _, lay, rf, rb, cw, cbz, cnr in cases:
        max_abs_err(bs.flood_labeled(lay, rf, rb, cw, cbz, cnr),
                    bs.flood_labeled_plain(lay, rf, rb, cw, cbz, cnr))
        max_abs_err((bs.flood_road(lay, rf, rb, cw, cbz),),
                    (bs.flood_road_plain(lay, rf, rb, cw, cbz),))
    print(f"    flood_labeled and flood_road on {len(cases)} flood_cases: "
          f"bit-equal", flush=True)

    # K10: the marker table on the flooded, unsorted layout; also on the
    # inputs of marker_cases, here and on the layout at capacity 1023.
    # The bound counts the slots the table depends on (r < num_rings,
    # slot < counts) read once.
    road = stenciled._replace(label=flooded)
    k10 = lambda: mk.marker_points(road, num_rings, kf)
    p10 = lambda: mk.marker_points_plain(road, num_rings, kf)
    markers = k10()
    assert float(markers[:, 0].sum()) > 0, "the scan must yield markers"
    ragged, _, _ = geometry.tensorize(x, y, z, ring_id, 1023, rings=r)
    ragged = fused_xz_zero(ragged, cfg)
    ragged, r_kf = bs.blind_spots(ragged, geometry.max_distance(ragged),
                                  num_rings, cfg)
    for lay, lkf in ((road, kf), (ragged, r_kf)):
        cases = marker_cases(lay, num_rings, lkf)
        for case, c_lay, c_nr, c_kf in cases:
            table = mk.marker_points(c_lay, c_nr, c_kf)
            max_abs_err((table,), (mk.marker_points_plain(c_lay, c_nr,
                                                          c_kf),))
            if case == "ties":
                assert int(table[:, 0].sum()) > 0, "ties must yield markers"
            if case == "past kf":
                assert not bool(table[:, 0].any())
    print(f"    marker_points on {[c for c, *_ in cases]} at {p} and 1023 "
          f"slots: bit-equal", flush=True)
    active = int(torch.where(torch.arange(r, device=dev) < num_rings,
                             torch.clamp(layout.counts, max=p), 0).sum())
    record("marker_points", (markers,), (p10(),), k10, p10,
           nbytes=12 * active + 4 * r + 361 * 8 + 361 * 24, ops=10 * active)

    # K13: the markers' first-pass keys on their own, one device op a
    # call.  The bound counts alpha and label of the active slots read
    # once (as K10's) and kf written.  The library call: one
    # scatter_reduce_ "amin" of the precomputed keys (the dump bin for
    # road or invalid slots) into a buffer that holds NO_KEY.
    k13 = lambda: mk.marker_first_nonroad(road, num_rings)
    p13 = lambda: mk.first_nonroad_keys(road, num_rings)
    a_ok13, bin13 = mk._bins(road, num_rings)
    idx13 = torch.where(a_ok13 & (road.label != 1), bin13, mk.N_BINS
                        ).reshape(-1)
    keys13 = mk.marker_keys(road.alpha).reshape(-1)
    buf13 = torch.full((mk.N_BINS + 1,), mk.NO_KEY, dtype=torch.int64,
                       device=dev)
    l13 = lambda: buf13.scatter_reduce_(0, idx13, keys13, "amin")
    assert torch.equal(l13()[:mk.N_BINS], p13())
    ops13 = _build.device_ops(k13)
    assert ops13 == 1, f"K13 must be one device op (no fill): {ops13}"
    record("marker_first_nonroad", (k13(), k13()), (p13(), kf), k13, p13,
           nbytes=8 * active + 4 * r + 4 + 361 * 8, ops=5 * active,
           library=l13)
    out["marker_first_nonroad"]["device_ops"] = ops13

    # K14: the marker state on the sorted layout, with the default offsets
    # and, untimed, with offsets and a floor of the SP path's form.  The
    # bound counts alpha and label of the active slots (as K10's), x and y
    # of their road slots and z of the 361 winners read once.
    srt = geometry.sort_by_azimuth(road)
    k14 = lambda: marker_state(srt, num_rings)
    p14 = lambda: marker_state_plain(srt, num_rings)
    state = k14()
    assert int((state[:, 1] > 0).sum()) > 10, "the scan must yield markers"
    rng = np.random.default_rng(9)
    goff = torch.from_numpy((np.arange(r) * (8 * p + 1) + rng.integers(
        0, 7 * p, r)).astype(np.int32)).to(dev)
    f_init = state[:, 0] + torch.from_numpy(rng.integers(
        -5, 5, 361).astype(np.float32)).to(dev) * p
    max_abs_err((marker_state(srt, num_rings, goff, f_init),),
                (marker_state_plain(srt, num_rings, goff, f_init),))
    record("marker_state", (state,), (p14(),), k14, p14,
           nbytes=state_bytes(srt, num_rings, r) + 4 * r + 361 * 28,
           ops=15 * active)

    # K11: gather + gate + pack on the final label table; then indices
    # outside the table, negative ones included, must read label 0.  The
    # library call: the indexed gather (with the clamps it needs).  The
    # bound counts the table sectors the in-range points can touch.
    table = flooded
    ok = torch.sum(valid) >= 30
    prr = int(cfg.probably_road_ring)
    k11 = lambda: gather_pack(table, ring_id, pos, valid, ok, prr)
    p11 = lambda: gather_pack_plain(table, ring_id, pos, valid, ok, prr)
    l11 = lambda: table[torch.clamp(ring_id, 0, r - 1).long(),
                        torch.clamp(pos, 0, p - 1).long()]
    rng = np.random.default_rng(5)
    bad_ids = torch.from_numpy(
        rng.integers(-5, r + 5, n).astype(np.int32)).to(dev)
    bad_pos = torch.from_numpy(
        rng.integers(-5, p + 5, n).astype(np.int32)).to(dev)
    max_abs_err(gather_pack(table, bad_ids, bad_pos, valid, ok, prr),
                gather_pack_plain(table, bad_ids, bad_pos, valid, ok, prr))
    # probably_road_ring equal to the ring count, the ring id of every
    # point without a ring: no point may be flagged.
    no_ring = gather_pack(table, ring_id, pos, valid, ok, r)
    max_abs_err(no_ring, gather_pack_plain(table, ring_id, pos, valid, ok, r))
    assert int((ring_id == r).sum()) > 0 and not bool(no_ring[2].any())
    record("gather_pack", k11(), p11(), k11, p11,
           nbytes=gather_bytes(table, (ring_id,), (pos,), ok[None]),
           ops=4 * n, library=l11)

    # The unfused path: K8 + K12, then K13 + K10, equals K8 + K9, K10.
    md = geometry.max_distance(layout)
    torch.cuda.synchronize()
    reset_launch_counts()
    unfused = bs.blind_spots(stenciled, md, num_rings, cfg,
                             want_marker_f=False)
    u_table = mk.marker_points(unfused, num_rings)
    torch.cuda.synchronize()
    unfused_launches = launch_counts()
    fused, f_kf = bs.blind_spots(stenciled, md, num_rings, cfg)
    max_abs_err((unfused.label, u_table),
                (fused.label, mk.marker_points(fused, num_rings, f_kf)))
    assert_launched(unfused_launches, UNFUSED_KERNELS, "the unfused path")
    print(f"    unfused path equals the fused one; launches "
          f"{ {k: v for k, v in unfused_launches.items() if v} }",
          flush=True)
    return out, unfused_launches


def gather_bytes(shape_of, ids, pos, ok) -> int:
    """The bytes K11 must move for lanes of (ids, pos): ids, pos and valid
    read and four byte planes written (13 per point), ok read, and per
    lane the distinct 32-byte sectors of its (R, P) int32 table that its
    in-range points read (none where the lane's gate is shut)."""
    r, p = shape_of.shape
    total = 0
    for b, (i, q) in enumerate(zip(ids, pos)):
        inr = ok[b] & (i >= 0) & (i < r) & (q >= 0) & (q < p)
        word = i[inr].long() * p + q[inr].long()
        total += 32 * torch.unique(word // 8).numel() + 13 * i.shape[0] + 1
    return total


def recorded_calls(owner, name: str, run) -> list:
    """The argument tuples of every call of owner.<name> that run() makes
    (the function still runs)."""
    fn = getattr(owner, name)
    recorded = []

    def recording(*args):
        recorded.append(args)
        return fn(*args)

    setattr(owner, name, recording)
    try:
        run()
    finally:
        setattr(owner, name, fn)
    return recorded


def phase_gather_batch(dev, planar, dims):
    """K11 over the phase-4 batch (128 planar scans, default configuration)
    in one launch, on the inputs process_batch gives it (recorded from a
    run): bit-equal to its plain version, one device op, timed beside the
    library call (one indexed gather of the stages' (128, R, P) tables)
    and its bound."""
    from urban_road_filter_torch import (
        FilterConfig, _build, pipeline, process_batch)
    from urban_road_filter_torch.ops.gather import (
        gather_pack_batch, gather_pack_batch_plain)

    (tables, ids, pos, valid, ok, prr), = recorded_calls(
        pipeline, "gather_pack_batch",
        lambda: process_batch(planar, FilterConfig(), dims, layout="planar"))
    b, n = ids.shape
    k11 = lambda: gather_pack_batch(tables, ids, pos, valid, ok, prr)
    p11 = lambda: gather_pack_batch_plain(tables, ids, pos, valid, ok, prr)
    err = max_abs_err(k11(), p11())
    ops = _build.device_ops(k11)
    assert ops == -(-b // 128), f"K11 over {b} lanes: {ops} device ops"
    r, p = tables[0].shape
    stacked, spos = tables, pos  # the stages' (B, R, P) and (B, N)
    lane = torch.arange(b, device=dev)[:, None]
    l11 = lambda: stacked[lane, torch.clamp(ids, 0, r - 1).long(),
                          torch.clamp(spos, 0, p - 1).long()]
    res = {"max_abs_err": err, "ms": cuda_ms(k11),
           "plain_ms": cuda_ms(p11, WALK_REPS),
           **bound(gather_bytes(tables[0], ids, pos, ok), 4 * b * n),
           "library_ms": cuda_ms(l11), "device_ops": ops}
    print(f"  gather_pack over the phase-4 batch ({b} lanes x {n} points, "
          f"{r} x {p} tables): bit-equal, {ops} device op, kernel "
          f"{res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, bound "
          f"{res['bound_ms']:.4f} ms ({res['bound_by']}), library "
          f"{res['library_ms']:.4f} ms", flush=True)
    return res


# ---- phase 2: the batched kernels (the batch path's lane axis) ----

BATCHED_KERNELS = ("star_walk", "group_rank", "group_place", "ring_geometry",
                   "flood_blocked", "flood_labeled", "marker_points")


def lane_scans(bench):
    """Phase 2's batch of lanes that differ, at the bench dims: 4 bench
    scans (64 rings), a scan of 10 points (under the 30-point gate), an
    empty scan, curb_gap at 24 rings and wall at 12 rings (2048
    azimuths)."""
    from urban_road_filter_torch.io import SCENES, make_scan

    return ([p for _, p in bench[:4]]
            + [np.tile(np.float32([[1, 0, -2, 0]]), (10, 1)),
               np.zeros((0, 4), np.float32),
               make_scan(SCENES["curb_gap"](), n_rings=24, n_azimuth=2048,
                         seed=5),
               make_scan(SCENES["wall"](), n_rings=12, n_azimuth=2048,
                         seed=6)])


def batch_probe(dev, pts, cfg, dims):
    """(probe, bound cfg): what each batched kernel was given in one
    process_batch run of the planar batch pts (pipeline._stages' probe)."""
    from urban_road_filter_torch import pipeline
    from urban_road_filter_torch.config import device_config

    bound_cfg = device_config(cfg, dev)
    probe = {}
    pipeline._batch_on(pts, bound_cfg, dims, "planar", probe=probe)
    return probe, bound_cfg


def lanewise(fn, *args):
    """fn on each lane of args through its B = 1 form (a lane's tensors, a
    RingLayout's fields; anything else as it is), stacked."""
    b = next(a for a in args if isinstance(a, torch.Tensor)).shape[0]

    def lane(a, k):
        if isinstance(a, torch.Tensor):
            return a[k]
        if isinstance(a, tuple) and hasattr(a, "_fields"):
            return a._make(lane(u, k) for u in a)
        return a

    outs = [fn(*(lane(a, k) for a in args)) for k in range(b)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(f) for f in zip(*outs))
    return (torch.stack(outs),)


def first_lane(fn, *args):
    """fn on lane 0 of args through its B = 1 form."""
    return lambda: fn(*(a[0] if isinstance(a, torch.Tensor)
                        else a._make(u[0] for u in a)
                        if isinstance(a, tuple) and hasattr(a, "_fields")
                        else a for a in args))


def batch_kernel_calls(d, bound_cfg, dims, curbs: bool) -> dict:
    """{kernel: (args, call, plain, nbytes, ops)} of each batched kernel
    on a batch probe: call(*args) launches it once over the batch, plain
    (*args) is its plain twin, the same call on a lane of args its B = 1
    form.  With ``curbs``, K8-K10 get one lane more: lane 0 with every
    slot a curb.  The bounds sum phase 2's per-scan formulas over the
    lanes."""
    from urban_road_filter_torch.ops import blind_spots as bs
    from urban_road_filter_torch.ops import geometry
    from urban_road_filter_torch.ops import markers as mk
    from urban_road_filter_torch.ops import star
    from urban_road_filter_torch.ops.place import (
        group_place, group_place_plain)
    from urban_road_filter_torch.ops.rank import (
        group_positions, group_positions_plain)

    r, p = dims.rings, dims.ring_capacity
    x, y, z, valid, keys = d["star"]
    ring_id = d["ring_id"]
    b, n = ring_id.shape
    calls = {}
    if keys is not None:
        fk, rk = star._star_keys(x, y, z, valid, bound_cfg, keys)
        nb = int((fk < 360).sum())
        calls["star_walk"] = (
            (fk, rk, z), lambda *a: star.star_search(*a, bound_cfg),
            lambda *a: star.star_search_plain(*a, bound_cfg),
            8 * b * n + 4 * nb + 360 * 4 * b, 20 * nb + 4 * b * n)
    calls["group_rank"] = (
        (ring_id,), lambda i: group_positions(i, r + 1),
        lambda i: group_positions_plain(i, r + 1),
        8 * b * n + 4 * (r + 1) * b, 4 * b * n)
    pos, counts = group_positions(ring_id, r + 1)
    calls["group_place"] = (
        (ring_id, pos, counts, x, y, z),
        lambda i, q, c, *f: group_place(i, q, c, f, r, p),
        lambda i, q, c, *f: group_place_plain(i, q, c, f, r, p),
        20 * b * n + 4 * (r + 1) * b + 12 * b * r * p + 4 * b, 2 * b * n)
    (placed,) = d["placed"]
    calls["ring_geometry"] = (
        (placed.x, placed.y, placed.counts), geometry.ring_geometry,
        geometry.ring_geometry_plain, rg_bytes(placed.counts, p), 0)
    layout, max_dist = d["stenciled"]
    num_rings = d["num_rings"]
    if curbs:
        cat = {f: torch.cat([getattr(layout, f), getattr(layout, f)[:1]])
               for f in layout._fields}
        cat["label"][-1] = 2
        layout = layout._replace(**cat)
        max_dist = torch.cat([max_dist, max_dist[:1]])
        num_rings = torch.cat([num_rings, num_rings[:1]])
    rows = layout.alpha.shape[0] * r
    slot_ok = torch.arange(p, device=ring_id.device) < layout.counts[..., None]
    counted = int(torch.clamp(layout.counts, 0, p).sum())
    n_curb = int((slot_ok & (layout.label == 2)).sum())
    n_aok = int((slot_ok & (layout.alpha >= 0)
                 & (layout.alpha <= 360)).sum())
    bz = bound_cfg.beam_zone
    w = bs.window_widths(max_dist, bz)
    calls["flood_blocked"] = (
        (layout, w), lambda lay, wk: bs.flood_blocked(lay, wk, bz),
        lambda lay, wk: bs.flood_blocked_plain(lay, wk, bz),
        8 * counted + 8 * rows + 2 * rows * 362,
        4 * n_curb + 2 * 362 * rows * 20)
    reach = bs.sweep_reach(layout, bs.flood_blocked(layout, w, bz), w,
                           num_rings, bound_cfg)
    lanes = layout.alpha.shape[0]
    calls["flood_labeled"] = (
        (layout, *reach, w, num_rings),
        lambda lay, rf, rb, wk, nr: bs.flood_labeled(lay, rf, rb, wk, bz,
                                                     nr),
        lambda lay, rf, rb, wk, nr: bs.flood_labeled_plain(lay, rf, rb, wk,
                                                           bz, nr),
        12 * rows * p + 2 * rows * 362 + 8 * rows + 361 * 8 * lanes,
        48 * n_aok)
    label, kf = bs.flood_labeled(layout, *reach, w, bz, num_rings)
    road = layout._replace(label=label)
    active = int(torch.where(torch.arange(r, device=ring_id.device)
                             < num_rings[:, None],
                             torch.clamp(road.counts, max=p), 0).sum())
    calls["marker_points"] = (
        (road, num_rings, kf), mk.marker_points, mk.marker_points_plain,
        12 * active + 4 * rows + 361 * 32 * lanes, 10 * active)
    return calls


def batch_library(name, args, dims):
    """The one PyTorch call that computes a batched kernel's function on
    its batch_kernel_calls args, or None where there is none: for K6 an
    index_put_ of the stacked x/y/z into a buffer with a dump ring and a
    dump slot per lane, indexed by lane, clamped ring and clamped slot (as
    phase 2's per-scan call, with the lane index it needs)."""
    if name != "group_place":
        return None
    r, p = dims.rings, dims.ring_capacity
    ring_id, pos, _, x, y, z = args
    b, n = ring_id.shape

    def l6():
        buf = torch.zeros((b, r + 1, p + 1, 3), dtype=torch.float32,
                          device=ring_id.device)
        lane = torch.arange(b, device=ring_id.device)[:, None].expand(b, n)
        return buf.index_put_((lane, torch.clamp(ring_id, max=r).long(),
                               torch.clamp(pos, max=p).long()),
                              torch.stack([x, y, z], -1))

    return l6


def once_ms(fn) -> float:
    """Device time of one call of fn, in ms (CUDA events, no repeats: for
    plain twins that take seconds on a batch)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def phase_batch_kernels(dev, bench, planar, dims) -> dict:
    """Each batched kernel (K4, K5, K6, K8 with a window row per lane, K9,
    K10) on the inputs process_batch gives it, with the star search on and
    off: over phase 4's batch (128 bench lanes) bit-equal to its plain
    twin and to the same kernel launched lane by lane through its B = 1
    form; over a batch of 8 lanes that differ (lane_scans, and a ninth of
    curbs only for K8-K10) the same.  Over the 128 lanes, star search on,
    each is timed: one launch for the batch (one device op), the 128
    launches of the B = 1 form, one launch on lane 0 (B = 1), the twin and
    the library call where there is one (batch_library), beside its bound.
    Returns {kernel: the b128 entry}."""
    from urban_road_filter_torch import FilterConfig, _build, pad_scan
    from urban_road_filter_torch import planarize_batch

    lanes8 = torch.from_numpy(planarize_batch(np.stack(
        [pad_scan(s, dims.max_points) for s in lane_scans(bench)]))).to(dev)
    out = {}
    for cname, cfg in (("star on", FilterConfig()),
                       ("star off", FilterConfig(star_shaped_method=False))):
        for differ, pts in ((False, planar), (True, lanes8)):
            what = (f"{pts.shape[1]} lanes that differ" if differ
                    else f"{pts.shape[1]} bench lanes")
            d, bound_cfg = batch_probe(dev, pts, cfg, dims)
            if differ:
                nr = d["num_rings"].tolist()
                assert len(set(nr)) >= 4 and 0 in nr, nr
            calls = batch_kernel_calls(d, bound_cfg, dims, curbs=differ)
            for name, (args, call, plain, nbytes, ops) in calls.items():
                k = lambda: call(*args)
                got = k()
                got = got if isinstance(got, tuple) else (got,)
                want = plain(*args)
                err = max_abs_err(got, want if isinstance(want, tuple)
                                  else (want,))
                max_abs_err(got, lanewise(call, *args))
                if cname != "star on" or differ:
                    continue
                ops1 = _build.device_ops(k)
                assert ops1 == 1, f"{name} over the batch: {ops1} device ops"
                lanes = lambda: lanewise(call, *args)
                lib = batch_library(name, args, dims)
                out[name] = {
                    "max_abs_err": err, "ms": cuda_ms(k),
                    "plain_ms": once_ms(lambda: plain(*args)),
                    **bound(nbytes, ops),
                    "library_ms": None if lib is None else cuda_ms(lib),
                    "device_ops": ops1, "lanes_ms": cuda_ms(lanes, 5),
                    "b1_ms": cuda_ms(first_lane(call, *args))}
                e = out[name]
                lib_ms = e["library_ms"]
                print(f"    {name} over {what}: bit-equal to its twin and "
                      f"to {pts.shape[1]} B = 1 launches; one launch "
                      f"{e['ms']:.4f} ms, {pts.shape[1]} B = 1 launches "
                      f"{e['lanes_ms']:.4f} ms, B = 1 (lane 0) "
                      f"{e['b1_ms']:.4f} ms, plain (once) "
                      f"{e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} "
                      f"ms ({e['bound_by']}), library "
                      f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}",
                      flush=True)
            print(f"  batched {', '.join(calls)} over {what}, {cname}: "
                  f"bit-equal to the twins and to lane-by-lane launches",
                  flush=True)
    assert set(out) == set(BATCHED_KERNELS), sorted(out)
    return out


def scans_for_pipeline():
    """The 7 synthetic scenes at OS1-64 density and 2 emulated drive scans."""
    from urban_road_filter_torch.io import SCENES, make_drive, make_scan

    scans = [(name, make_scan(spec(), n_rings=64, n_azimuth=2048, seed=i))
             for i, (name, spec) in enumerate(SCENES.items())]
    scans += [(f"os1_64_drive_{k}", s) for k, s in
              enumerate(make_drive(2, sensor="os1_64", seed=41))]
    return scans


def phase_pipeline(dev, dims, configs, scans):
    """packed_scan on every scan in every configuration; returns per run
    (configuration, scan index, host outputs, p50 ms) and the launch counts
    of all the runs."""
    from urban_road_filter_torch import (
        launch_counts, pad_scan, packed_scan, reset_launch_counts)

    hosts = [torch.from_numpy(pad_scan(pts, dims.max_points)).pin_memory()
             for _, pts in scans]
    torch.cuda.synchronize()
    reset_launch_counts()
    runs = []
    for cname, cfg in configs.items():
        for k, host in enumerate(hosts):
            times = []
            for _ in range(1 + SCAN_REPS):
                t0 = time.perf_counter()
                out = packed_scan(host.to(dev, non_blocking=True), cfg, dims)
                fetched = [t.cpu() for t in out]  # synchronises
                times.append(time.perf_counter() - t0)
                assert all(t.device.type == "cuda" for t in out)
            runs.append((cname, k, fetched,
                         statistics.median(times[1:]) * 1e3))
    return runs, launch_counts()


def same_lanes(batch, dev_pts, cfg, dims):
    """Every lane of a process_batch result equals process_scan of its scan
    (planar (3, B, N) on the card), bit for bit on every field."""
    from urban_road_filter_torch import process_scan

    for b in range(dev_pts.shape[1]):
        one = process_scan(dev_pts[:, b], cfg, dims, layout="planar")
        for f, got, want in zip(one._fields, batch, one):
            try:
                max_abs_err((got[b],), (want,))
            except AssertionError as e:
                raise AssertionError(f"lane {b} field {f}: {e}") from None


def gate_lanes(device_parity_gate, fetched, scans, lanes, cfg, what,
               channels=None):
    """The oracle gate on the named lanes of a fetched batch result."""
    for b in lanes:
        name, pts = scans[b]
        labels = fetched.labels[b].numpy()
        markers = fetched.markers[b].numpy()
        assert np.isfinite(markers).all() and int(labels.max()) <= 2
        assert bool(fetched.ok[b]) and int(fetched.num_rings[b]) > 0
        agree, n_sys = device_parity_gate(pts, labels, markers, cfg, name,
                                          channels=channels)
        print(f"  {what} lane {b} {name}: parity {agree:.6f}, systematic "
              f"{n_sys}, rings {int(fetched.num_rings[b])}", flush=True)
        assert agree >= 0.999 and n_sys == 0, (what, b, name, agree, n_sys)


def phase_batch(dev, cfg, scans, merged, dims, mdims, smi,
                device_parity_gate):
    """process_batch on the replay benchmark's batch (scans, at dims); then
    on the 9 scenes with the star search on and off, and on 4 merged
    multi-LiDAR scans (merged, at mdims).  Returns the launch counts of the
    benchmark batch's runs."""
    from urban_road_filter_torch import (
        ScanResult, _build, launch_counts, pad_scan, planarize_batch,
        process_batch, reset_launch_counts)

    host = torch.from_numpy(planarize_batch(np.stack(
        [pad_scan(pts, dims.max_points) for _, pts in scans]))).pin_memory()
    torch.cuda.synchronize()
    reset_launch_counts()
    times = []
    for _ in range(1 + BATCH_REPS):
        t0 = time.perf_counter()
        res = process_batch(host.to(dev, non_blocking=True), cfg, dims,
                            layout="planar")
        fetched = ScanResult(*(t.cpu() for t in res))  # synchronises
        times.append(time.perf_counter() - t0)
    launches = launch_counts()
    b = host.shape[1]
    step = statistics.median(times[1:])
    print(f"  B={b}: {b / step:.3f} scans/s host to host ({step * 1e3:.3f} "
          f"ms per batch, median of {BATCH_REPS}, outputs fetched) on "
          f"{smi}", flush=True)
    assert int(fetched.overflow.max()) == 0, "ring capacity overflow"
    assert int(fetched.star_overflow.max()) == 0
    x = host.to(dev)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    torch.cuda.synchronize()
    with _build.recording(), torch.cuda.graph(graph):
        process_batch(x, cfg, dims, layout="planar")
    print(f"  one process_batch of {b} lanes: {_build.graph_nodes(graph)} "
          f"device ops (the nodes of its capture)", flush=True)
    graph.reset()
    same_lanes(res, x, cfg, dims)
    print(f"  all {b} lanes equal process_scan bit for bit", flush=True)
    gate_lanes(device_parity_gate, fetched, scans, range(4), cfg, "bench")

    mixed = scans_for_pipeline()
    pts = torch.from_numpy(planarize_batch(np.stack(
        [pad_scan(p, dims.max_points) for _, p in mixed]))).to(dev)
    for what, c in (("scenes", cfg),
                    ("scenes star off", cfg.replace(star_shaped_method=False))):
        res = process_batch(pts, c, dims, layout="planar")
        same_lanes(res, pts, c, dims)
        fetched = ScanResult(*(t.cpu() for t in res))
        assert int(fetched.overflow.max()) == 0
        gate_lanes(device_parity_gate, fetched, mixed, range(len(mixed)), c,
                   what)

    pts = torch.from_numpy(planarize_batch(np.stack(
        [pad_scan(p, mdims.max_points) for _, p in merged]))).to(dev)
    res = process_batch(pts, cfg, mdims, layout="planar")
    same_lanes(res, pts, cfg, mdims)
    fetched = ScanResult(*(t.cpu() for t in res))
    assert int(fetched.overflow.max()) == 0
    assert int(fetched.num_rings.min()) > 64
    gate_lanes(device_parity_gate, fetched, merged, [1], cfg, "multi-LiDAR",
               channels=mdims.rings)
    return launches


def sp_dims() -> dict:
    """{name: dims} of phase 5's two SP deployments."""
    from urban_road_filter_torch import PipelineDims

    return {"os1_128_262k": PipelineDims(max_points=262144, rings=128,
                                         ring_capacity=2048,
                                         beam_capacity=1024),
            "os1_64_preset": PipelineDims.for_sensor("os1-64")}


def sp_deployments():
    """(name, dims, azimuth-sorted scan, oracle channels) of phase 5: the
    JAX package's production SP test (the emulated OS1-128 drive, seed 31,
    2048 firings, 262144 points) and the OS1-64 preset on a drive scan."""
    from urban_road_filter_torch.io import make_drive
    from urban_road_filter_torch.parallel.azimuth_parallel import (
        azimuth_sorted)

    dims = sp_dims()
    return [("os1_128_262k", dims["os1_128_262k"],
             azimuth_sorted(next(make_drive(1, sensor="os1_128", seed=31,
                                            firings=2048))), 128),
            ("os1_64_preset", dims["os1_64_preset"],
             azimuth_sorted(next(make_drive(1, sensor="os1_64", seed=41))),
             None)]


def boundary_flips(got, want, pts) -> int:
    """Label flips between two runs of one scan; each must sit within 1e-4
    degrees of an integer azimuth (a one-ulp bin edge).  Returns their
    count."""
    from urban_road_filter_torch.oracle.reference import azimuth_2d

    flips = np.flatnonzero(got != want)
    if flips.size:
        _, aa = azimuth_2d(pts[flips, 0].astype(np.float32),
                           pts[flips, 1].astype(np.float32))
        aa = np.where(np.isnan(aa), 0.5, aa)
        assert (np.abs(aa - np.round(aa)) <= 1e-4).all(), (
            "SP labels differ from process_scan away from a bin edge")
    return int(flips.size)


def wedge_kernels(probe, rings: int, cfg) -> None:
    """K4, K5, K7, K8 and K12-K14 against their twins on the inputs of a
    real SP run: K4 on each wedge's star keys, K5 on the ids of its two
    calls, K7's SP entry on the stacked layout before the stencils, K8 and
    K14 over the stacked sorted layout (both passes of K14, with its
    g_offset and f_init), K12 and K13 on each wedge's layout with its
    reach and window widths."""
    from urban_road_filter_torch.ops import blind_spots as bs
    from urban_road_filter_torch.ops import markers as mk
    from urban_road_filter_torch.ops import star
    from urban_road_filter_torch.ops.rank import (
        group_positions, group_positions_plain)
    from urban_road_filter_torch.parallel.azimuth_parallel import _rows

    bz = cfg.beam_zone
    xw, yw, zw, vw, fkw, rkw = probe["star"]
    for k in range(WEDGES):
        fk, rk = star._star_keys(xw[k], yw[k], zw[k], vw[k], cfg,
                                 (fkw[k], rkw[k]))
        max_abs_err((star.star_search(fk, rk, zw[k], cfg),),
                    (star.star_search_plain(fk, rk, zw[k], cfg),))
    for groups, ids in probe["rank_ids"].items():
        max_abs_err(group_positions(ids, groups),
                    group_positions_plain(ids, groups))
    k7, p7, table = sp_stencil_calls(probe, cfg)
    k7()
    max_abs_err((table,), (p7(),))
    nr = probe["num_rings"]
    reach = (probe["reach_f"], probe["reach_b"])
    for call, _ in sp_stacked_calls(probe, bz).values():
        max_abs_err(call(False), call(True))
    for k in range(WEDGES):
        lay = _rows(probe["layout"], k, rings)
        max_abs_err((bs.flood_road(lay, *reach, probe["w"], bz),
                     mk.marker_first_nonroad(lay, nr)),
                    (bs.flood_road_plain(lay, *reach, probe["w"], bz),
                     mk.first_nonroad_keys(lay, nr)))


def state_bytes(lay, num_rings, rings: int) -> int:
    """The bytes K14 must read of a (D * rings, P) layout: alpha and label
    of the active slots (ring < num_rings in its wedge, slot < counts), x
    and y of those that are road with a valid azimuth."""
    rows, p = lay.alpha.shape
    dev = lay.alpha.device
    active = ((torch.arange(p, device=dev)[None, :] < lay.counts[:, None])
              & ((torch.arange(rows, device=dev) % rings) < num_rings)[:,
                                                                       None])
    road = (active & (lay.label == 1) & (lay.alpha >= 0)
            & (lay.alpha <= 360))
    return 8 * int(active.sum()) + 8 * int(road.sum())


def sp_stacked_calls(probe, bz) -> dict:
    """{name: (call(plain), (bytes, operations))}: K8 and K14's two passes
    over the stacked sorted layout of an SP run, as the SP path calls them
    (one launch each over every wedge); call(True) runs the plain twin.
    The bounds count the slots each reads once (K8: alpha and label of the
    counted slots; K14: state_bytes, and z of its winners) and the outputs
    written once."""
    from urban_road_filter_torch.ops import blind_spots as bs
    from urban_road_filter_torch.ops.marker_state import (
        marker_state, marker_state_plain)

    lay, nr = probe["layout"], probe["num_rings"]
    goff, f = probe["g_offset"], probe["f_init"]
    rows, p = lay.alpha.shape
    f_init = f.expand(WEDGES, f.shape[0])
    k8 = (bs.flood_blocked, bs.flood_blocked_plain)
    k14 = (marker_state, marker_state_plain)
    counted = int(torch.clamp(lay.counts, 0, p).sum())
    k14_bytes = (state_bytes(lay, nr, rows // WEDGES) + 8 * rows
                 + WEDGES * 361 * 28)
    return {
        "flood_blocked": (lambda plain: k8[plain](
            lay, probe["w"], bz, wedges=WEDGES),
            (8 * counted + 4 * rows + 2 * rows * 362,
             4 * counted + 2 * 362 * rows * 20)),
        "marker_state pass 1": (lambda plain: (k14[plain](
            lay, nr, goff, wedges=WEDGES),),
            (k14_bytes, 15 * counted)),
        "marker_state pass 2": (lambda plain: (k14[plain](
            lay, nr, goff, f_init, wedges=WEDGES),),
            (k14_bytes + WEDGES * 361 * 4, 15 * counted)),
    }


def sp_stencil_calls(probe, cfg):
    """(kernel, plain, table): K7's SP entry on the stacked layout of an SP
    run before its stencils, in place on ``table`` (a copy of that
    layout's label; the marks ignore the label, so calls repeat them), and
    its plain twin, which returns the new table."""
    from urban_road_filter_torch.ops.stencil_kernels import (
        fused_xz_zero_halo, xz_zero_halo_plain)

    lay, left, right, prefix, total = probe["halo"]
    table = lay.label.clone()
    return (lambda: fused_xz_zero_halo(lay._replace(label=table), left,
                                       right, prefix, total, cfg),
            lambda: xz_zero_halo_plain(lay, left, right, prefix, total, cfg),
            table)


def phase_sp_stacked(dev, cfg) -> dict:
    """K7's SP entry, the ring geometry in both its SP calls, K8 and K14's
    two passes at the SP path's stacked shape (8 wedges of the OS1-128
    scan's 128 x 384 slots) against their twins, on the inputs of one SP
    run, timed beside their bounds; returns K7's entry's results (its "sp"
    entry of the kernels line)."""
    from urban_road_filter_torch import _build, pad_scan
    from urban_road_filter_torch.ops import geometry
    from urban_road_filter_torch.parallel.azimuth_parallel import (
        make_azimuth_pipeline)

    name, dims, scan, _ = sp_deployments()[0]
    probe = {}
    make_azimuth_pipeline(WEDGES, cfg, dims, device=dev)(
        torch.from_numpy(pad_scan(scan, dims.max_points)).to(dev),
        probe=probe)
    rows, p = probe["layout"].alpha.shape
    # K7's SP entry.  The bound counts x/y/z of the slots below counts and
    # of the valid halo points read once, counts, the halo counts and
    # prefix (16 B a row) and total read, and each new mark written once.
    k7, p7, table = sp_stencil_calls(probe, cfg)
    ops7 = _build.device_ops(k7)
    assert ops7 == 1, f"K7's SP entry must be one device op: {ops7}"
    lay, left, right, _, _ = probe["halo"]
    err = max_abs_err((table,), (p7(),))
    counted = int(torch.clamp(lay.counts, 0, p).sum())
    halo_pts = int(left["n"].sum() + right["n"].sum())
    n_marks = int(((table == 2) & (lay.label != 2)).sum())
    nbytes = 12 * (counted + halo_pts) + 16 * rows + 4 * dims.rings + (
        4 * n_marks)
    res = {"max_abs_err": err, "ms": cuda_ms(k7), "plain_ms": cuda_ms(p7),
           **bound(nbytes, (60 + 8 * int(cfg.curb_points)) * counted),
           "library_ms": None, "device_ops": ops7}
    print(f"    xz_zero SP entry at the SP shape ({name}, {WEDGES} wedges x "
          f"{rows // WEDGES} x {p}): bit-equal, 1 device op, kernel "
          f"{res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, bound "
          f"{res['bound_ms']:.5f} ms ({res['bound_by']}: 12 B x ({counted} "
          f"slots + {halo_pts} halo points) + 16 B x {rows} rows + 4 B x "
          f"{dims.rings} totals + 4 B x {n_marks} new marks = {nbytes} B)",
          flush=True)
    # The ring geometry as sp_tensorize calls it (d2, alpha and the max of
    # the placed wedges: the layout K7 was given) and as sort_by_azimuth
    # does (the same of those rows sorted by azimuth), no label or pid
    # planes.  The bound: rg_bytes without them.
    for what, rl in (("sp_tensorize", lay),
                     ("sort_by_azimuth",
                      geometry.sort_by_azimuth(lay, carry_pid=True))):
        args = (rl.x, rl.y, rl.counts, False)
        kg = lambda: geometry.ring_geometry(*args)
        pg = lambda: geometry.ring_geometry_plain(*args)
        max_abs_err(*(tuple(t for t in g() if t is not None)
                      for g in (kg, pg)))
        b = bound(rg_bytes(rl.counts, p, False), 0)
        print(f"    ring_geometry ({what}) at the SP shape ({name}, "
              f"{WEDGES} wedges x {rows // WEDGES} x {p}): bit-equal, "
              f"kernel {cuda_ms(kg):.4f} ms, plain {cuda_ms(pg):.4f} ms, "
              f"bound {b['bound_ms']:.5f} ms ({b['bound_by']})", flush=True)
    for what, (call, (nbytes, ops)) in sp_stacked_calls(
            probe, cfg.beam_zone).items():
        max_abs_err(call(False), call(True))
        b = bound(nbytes, ops)
        print(f"    {what} at the SP shape ({name}, {WEDGES} wedges x "
              f"{rows // WEDGES} x {p}): bit-equal, kernel "
              f"{cuda_ms(lambda: call(False)):.4f} ms, plain "
              f"{cuda_ms(lambda: call(True)):.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']})", flush=True)
    return res


def phase_sp(dev, configs, smi, device_parity_gate):
    """make_azimuth_pipeline(8 wedges) on each deployment in each
    configuration; returns the launch counts of all the runs."""
    from urban_road_filter_torch import (
        ScanResult, launch_counts, pad_scan, process_scan,
        reset_launch_counts)
    from urban_road_filter_torch.parallel import azimuth_parallel as ap
    from urban_road_filter_torch.parallel.azimuth_parallel import (
        make_azimuth_pipeline)
    from urban_road_filter_torch.utils.parity import marker_rows_boundary_ok
    from urban_road_filter_torch.ops.markers import compact_markers

    deployments = sp_deployments()
    total = {}
    for name, dims, scan, channels in deployments:
        host = torch.from_numpy(pad_scan(scan, dims.max_points)).pin_memory()
        per_wedge = dims.max_points // WEDGES
        print(f"  {name}: {len(scan)} points, {WEDGES} wedges of "
              f"{per_wedge} points, {dims.rings} rings", flush=True)
        for cname, cfg in configs.items():
            # The stages op by op (run.eager; phase 10 replays the graph).
            run = make_azimuth_pipeline(WEDGES, cfg, dims, device=dev).eager
            torch.cuda.synchronize()
            reset_launch_counts()
            times = []
            for _ in range(1 + SCAN_REPS):
                t0 = time.perf_counter()
                res = run(host.to(dev, non_blocking=True))
                fetched = ScanResult(*(t.cpu() for t in res))
                times.append(time.perf_counter() - t0)
            launches = launch_counts()
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            want = SP_KERNELS if cfg.star_shaped_method else tuple(
                k for k in SP_KERNELS if k != "star_walk")
            assert_launched(launches, want, f"the SP path ({name} {cname})")
            runs = 1 + SCAN_REPS  # K7 and K8 once, K14 and the ring
            # geometry twice per SP scan
            assert launches["flood_blocked"] == runs, launches
            assert launches["marker_state"] == 2 * runs, launches
            assert launches["ring_geometry"] == 2 * runs, launches
            assert launches["xz_zero"] == runs, launches
            assert int(fetched.overflow) == 0, "SP overflow"
            assert bool(fetched.ok) and int(fetched.num_rings) > 0
            labels = fetched.labels.numpy()
            markers = fetched.markers.numpy()
            assert np.isfinite(markers).all() and int(labels.max()) <= 2
            one = ScanResult(*(t.cpu() for t in process_scan(
                host.to(dev), cfg, dims, device=dev)))
            n_flips = boundary_flips(labels, one.labels.numpy(),
                                     host.numpy())
            rows, bins = compact_markers(markers)
            orows, obins = compact_markers(one.markers.numpy())
            assert np.array_equal(bins, obins), "SP marker bins differ"
            diff = ~np.all(rows == orows, axis=1)
            assert marker_rows_boundary_ok(rows[diff, :3],
                                           orows[diff, :3]).all()
            agree, n_sys = device_parity_gate(scan, labels, markers, cfg,
                                              name, channels=channels)
            p50 = statistics.median(times[1:]) * 1e3
            print(f"  {name} {cname}: SP latency p50 {p50:.3f} ms host to "
                  f"host on {smi}; vs process_scan: {n_flips} boundary "
                  f"label flips, {int(diff.sum())} marker rows differ; "
                  f"parity {agree:.6f}, systematic {n_sys}, rings "
                  f"{int(fetched.num_rings)}, overflow "
                  f"{int(fetched.overflow)}", flush=True)
            assert agree >= 0.999 and n_sys == 0, (name, cname, agree, n_sys)
            print(f"    launches: "
                  f"{ {k: v for k, v in launches.items() if v} }")
        probe = {}
        run = make_azimuth_pipeline(WEDGES, configs["default"], dims,
                                    device=dev)
        run(host.to(dev), probe=probe)
        wedge_kernels(probe, dims.rings, configs["default"])
        print(f"  {name}: K4 ({per_wedge} points), K12, K13 ({dims.rings} "
              f"x {probe['layout'].x.shape[1]} slots) on each wedge, K7, K8 "
              f"and K14 over the {WEDGES} stacked wedges and K5 at "
              f"{sorted(probe['rank_ids'])} groups bit-equal to their "
              f"twins", flush=True)
        # The sp_xz_zero stage (halo exchange, then K7), again in place on
        # the probe's copy of its layout.
        lay = probe["halo"][0]
        ops = profiled_ops(lambda: ap._halo_stencils(
            ap.LocalWedges(WEDGES), lay, dims.rings, configs["default"],
            lay.counts.view(WEDGES, dims.rings)))
        print(f"  {name}: the sp_xz_zero stage: {ops} device ops per SP "
              f"scan (torch.profiler), K7 one of them", flush=True)
    return total


def same_outputs(got, want, what: str) -> None:
    """Two runs' ScanOutputs equal field by field: the clouds bit for bit,
    the marker strips (id, color, points), ok and the stats' counts."""
    assert [o.seq for o in got] == [o.seq for o in want], what
    for a, b in zip(got, want):
        assert a.ok == b.ok, (what, a.seq)
        for f in ("road", "curb", "roi", "road_probably"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.shape == y.shape and np.array_equal(
                x.view(np.int32), y.view(np.int32)), (what, a.seq, f)
        assert len(a.marker_strips) == len(b.marker_strips), (what, a.seq)
        for u, v in zip(a.marker_strips, b.marker_strips):
            assert (u.id, u.color) == (v.id, v.color), (what, a.seq)
            assert np.array_equal(u.points, v.points), (what, a.seq)
        for f in ("points_in", "points_roi", "num_rings", "road_points",
                  "curb_points", "marker_count", "overflow"):
            assert getattr(a.stats, f) == getattr(b.stats, f), (what, f)


def phase_replay(dev, smi, device_parity_gate) -> dict:
    """The port's replay harness (io.replay.ReplayHarness) on the card:
    (a) the three recorded-style PCD fixtures, read by the native reader,
    with their NaN rows; (b) ~30 emulated OS1-64 drive scans at 10 Hz in
    drop mode at depth 1, then flat out at depth 2, equal field by field;
    (c) SP mode (8 wedges) on OS1-128 drive scans against the topics of
    make_azimuth_pipeline's own results; (d) a bag of 3 scans written and
    replayed.  Launch counters are zeroed before each part and read after
    it.  Returns the launch counts summed over the parts."""
    import glob
    import os
    import tempfile

    from urban_road_filter_torch import (
        FilterConfig, PipelineDims, ScanResult, launch_counts,
        pad_scan_planar, reset_launch_counts)
    from urban_road_filter_torch.io import make_drive, read_bag, write_bag
    from urban_road_filter_torch.io.pcd import read_pcd
    from urban_road_filter_torch.io.replay import (
        ReplayHarness, bag_source, pcd_dir_source)
    from urban_road_filter_torch.parallel.azimuth_parallel import (
        azimuth_sorted, make_azimuth_pipeline)
    from urban_road_filter_torch.runtime import native

    class Recording(ReplayHarness):
        """Keeps each scan's fetched host outputs beside its topics."""

        def _postprocess(self, raw, host_out, *args, **kw):
            out = super()._postprocess(raw, host_out, *args, **kw)
            self.fetched.append((raw, host_out, out))
            return out

    def replay(source, **kw):
        h = Recording(device=dev, **kw)
        h.fetched = []
        torch.cuda.synchronize()
        reset_launch_counts()
        m = h.run(source)
        torch.cuda.synchronize()
        launches = launch_counts()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        s = m.summary()
        assert s["errors"] == 0, (s, m.last_error)
        return h, s, launches

    total = {}
    cfg = FilterConfig()
    # (a) The fixtures: 16384 points, binary_compressed, NaN rows.
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "fixtures")
    paths = sorted(glob.glob(os.path.join(fixtures, "*.pcd")))
    assert len(paths) == 3, paths
    assert native.get_lib() is not None, "the native PCD reader must build"
    for path in paths:
        fast = native.read_pcd_native(path)
        assert fast is not None and np.array_equal(
            fast.view(np.int32), read_pcd(path, use_native=False).view(
                np.int32)), path
    fdims = PipelineDims(16384, 64, 1024, 256)
    h, s, launches = replay(pcd_dir_source(fixtures), cfg=cfg, dims=fdims)
    assert_launched(launches, SCAN_KERNELS, "the replay of the fixtures")
    assert s["scans"] == 3 and s["not_ok"] == 0, s
    for path, (raw, host_out, out) in zip(paths, h.fetched):
        labels, markers, overflow = host_out[0], host_out[3], host_out[6]
        nan = np.isnan(raw[:, 0])
        assert nan.sum() > 100 and not labels[:len(raw)][nan].any()
        assert out.ok and int(overflow) == 0
        assert not np.isnan(out.road).any() and not np.isnan(out.curb).any()
        agree, n_sys = device_parity_gate(raw, labels, markers, cfg,
                                          os.path.basename(path))
        print(f"  fixture {os.path.basename(path)}: {len(raw)} points, "
              f"{int(nan.sum())} NaN rows, parity {agree:.6f}, systematic "
              f"{n_sys}, rings {out.stats.num_rings}, overflow 0, "
              f"latency {out.stats.latency_ms:.3f} ms", flush=True)
        assert agree >= 0.999 and n_sys == 0, (path, agree, n_sys)

    # (b) The OS1-64 drive at 10 Hz (drop mode, depth 1), then flat out at
    # depth 2: the same outputs.
    dims = PipelineDims.for_sensor("os1-64")
    drive = list(make_drive(30, sensor="os1_64", seed=43))
    runs = {}
    for what, kw in (("10 Hz depth 1", dict(rate_hz=10.0)),
                     ("flat out depth 2", dict(pipeline_depth=2))):
        got = []
        h, s, launches = replay(iter(drive), cfg=cfg, dims=dims,
                                on_scan=got.append, **kw)
        assert_launched(launches, SCAN_KERNELS, f"the replay {what}")
        assert s["not_ok"] == 0 and s["dropped"] == 0, (what, s)
        runs[what] = got
        lat = s["latency_ms"]
        print(f"  OS1-64 drive, {what}: {s['scans']} scans, {s['dropped']} "
              f"dropped, {s['errors']} errors, latency p50 {lat['p50']} ms, "
              f"p99 {lat['p99']} ms, {s['scans_per_sec']} scans/s on {smi}",
              flush=True)
    same_outputs(runs["flat out depth 2"], runs["10 Hz depth 1"],
                 "depth 2 vs depth 1")
    print("  depth 2 outputs equal depth 1's field by field", flush=True)

    # (c) SP mode: 8 wedges on OS1-128 drive scans; topics equal those of
    # make_azimuth_pipeline's own results, postprocessed in order.
    _, sdims, _, _ = sp_deployments()[0]
    sp_scans = [azimuth_sorted(p) for p in
                make_drive(3, sensor="os1_128", seed=31, firings=2048)]
    got = []
    h, s, launches = replay(iter(sp_scans), cfg=cfg, dims=sdims,
                            azimuth_shard=WEDGES, on_scan=got.append)
    assert_launched(launches, SP_KERNELS, "the SP replay")
    # The harness replays the compiled SP run: 3 replays and the eager run
    # before its capture.
    assert launches["flood_blocked"] == 4 and launches["marker_state"] == 8
    run = make_azimuth_pipeline(WEDGES, cfg, sdims, device=dev).eager
    ref = ReplayHarness(cfg=cfg, dims=sdims, device=dev)
    want = []
    for k, scan in enumerate(sp_scans):
        res = run(torch.from_numpy(pad_scan_planar(scan, sdims.max_points))
                  .to(dev), layout="planar")
        assert isinstance(res, ScanResult)
        host = tuple(t.cpu().numpy() for t in (
            res.labels, res.roi, res.probably_road, res.markers, res.ok,
            res.num_rings, res.overflow))
        ref._seq = k
        want.append(ref._postprocess(scan, host, 0.0))
    same_outputs(got, want, "SP replay")
    print(f"  SP replay ({WEDGES} wedges, {len(sp_scans)} OS1-128 scans of "
          f"{len(sp_scans[0])} points): topics equal make_azimuth_pipeline's"
          f"; latency p50 {s['latency_ms']['p50']} ms", flush=True)

    # (d) A bag of 3 scans, written and replayed.
    with tempfile.TemporaryDirectory() as tmp:
        bag = os.path.join(tmp, "drive.bag")
        write_bag(bag, drive[:3], topic="/os1/points")
        back = list(read_bag(bag))
        for a, b in zip(drive[:3], back):
            assert np.array_equal(a[:, :4], b)
        got = []
        h, s, launches = replay(bag_source(bag), cfg=cfg, dims=dims,
                                on_scan=got.append)
    assert s["scans"] == 3 and s["not_ok"] == 0, s
    same_outputs(got, runs["10 Hz depth 1"][:3], "bag replay")
    print("  bag of 3 scans: read back bit-equal, replayed, outputs equal "
          "the drive's", flush=True)
    return total


# Each port-side kernel launch's stage: the urf::<stage> range that must
# hold its urf::k::<kernel> range (pipeline._stage, _build.launch).
STAGE_OF = {"ingest_prep": "ingest", "discover_rings": "ingest",
            "assign_rings": "ingest", "star_walk": "star",
            "group_rank": "tensorize", "group_place": "tensorize",
            "ring_geometry": "tensorize", "xz_zero": "xz_zero",
            "flood_blocked": "blind_spots", "flood_labeled": "blind_spots",
            "marker_points": "markers", "gather_pack": "gather"}
SCAN_DEVICE_OPS = 179  # packed_scan's device ops at the OS1-64 preset,
# H2D and D2H of its outputs included (PERF.md section 5)


def same_result(got, want, what: str) -> None:
    """Two ScanResults (or tuples of tensors) equal field by field, floats
    by their bits."""
    for f, g, w in zip(getattr(want, "_fields", range(len(want))), got,
                       want):
        g, w = g.cpu(), w.cpu()
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert g.dtype == w.dtype and torch.equal(g, w), (what, f)


def phase_checked(dev, dims, configs, scans, smi) -> dict:
    """utils.checked.process_scan_checked on phase 3's scans in each
    configuration, in turns with process_scan: every field bit-equal, the
    error word clean; the host-to-host p50 of both printed.  Then the
    negative controls: each contract's predicate on a corrupted copy of one
    scan's index tensors (its probe) sets its bit, and on the clean ones
    none.  Returns the checked runs' launch counts."""
    from urban_road_filter_torch import (
        FilterConfig, launch_counts, pad_scan, process_scan,
        reset_launch_counts)
    from urban_road_filter_torch.ops.markers import NO_KEY
    from urban_road_filter_torch.utils import checked as ck

    hosts = [torch.from_numpy(pad_scan(pts, dims.max_points)).pin_memory()
             for _, pts in scans]
    # Each path's launches are counted from its own calls alone: the
    # counters are zeroed just before each call and added up after it.
    tally = {"process_scan": {}, "process_scan_checked": {}}

    def counted(path, fn):
        reset_launch_counts()
        out = fn()
        for k, v in launch_counts().items():
            tally[path][k] = tally[path].get(k, 0) + v
        return out

    torch.cuda.synchronize()
    for cname, cfg in configs.items():
        times = {"process_scan": [], "process_scan_checked": []}
        for k, host in enumerate(hosts):
            for rep in range(1 + SCAN_REPS):
                t0 = time.perf_counter()
                want = counted("process_scan", lambda: [
                    t.cpu() for t in process_scan(
                        host.to(dev, non_blocking=True), cfg, dims)])
                t1 = time.perf_counter()
                err, got = counted(
                    "process_scan_checked", lambda: ck.process_scan_checked(
                        host.to(dev, non_blocking=True), cfg, dims,
                        throw=False))
                fetched = [t.cpu() for t in (*got, err.word)]
                t2 = time.perf_counter()
                if rep:
                    times["process_scan"].append(t1 - t0)
                    times["process_scan_checked"].append(t2 - t1)
            same_result(fetched[:-1], want, (cname, scans[k][0]))
            msg = ck.CheckError(fetched[-1]).get()
            assert msg is None, (cname, scans[k][0], msg)
        p50 = {m: statistics.median(v) * 1e3 for m, v in times.items()}
        print(f"  {cname}: {len(hosts)} scans equal process_scan field by "
              f"field, error word clean; host-to-host p50 process_scan "
              f"{p50['process_scan']:.3f} ms, process_scan_checked "
              f"{p50['process_scan_checked']:.3f} ms (all outputs fetched, "
              f"{SCAN_REPS} runs a scan in turns) on {smi}", flush=True)
    launches = tally["process_scan_checked"]
    # One launch of each kernel per checked call (the star walk only where
    # the configuration has it on), as many as process_scan's own calls.
    calls = len(hosts) * (1 + SCAN_REPS)
    for name in SCAN_KERNELS:
        want_n = calls * sum(1 for c in configs.values()
                             if name != "star_walk" or c.star_shaped_method)
        assert launches.get(name, 0) == want_n, (name, launches, want_n)
    assert launches == tally["process_scan"], tally

    # Negative controls on the card, from one clean scan's probe.
    probe = {}
    cfg0 = FilterConfig()
    ck.process_scan_checked(hosts[-1].to(dev), cfg0, dims, probe=probe)
    rings, cap = dims.rings, dims.ring_capacity
    valid, ring_id, num_rings = (probe[k] for k in
                                 ("valid", "ring_id", "num_rings"))
    pos, hp, lay, kf = (probe[k] for k in ("pos", "hp", "layout", "kf"))
    w = probe["w"]
    i = int(torch.nonzero(valid & (ring_id < rings))[0])
    j = int(torch.nonzero(kf != NO_KEY)[0])

    def with_(t, idx, v):
        t = t.clone()
        t[idx] = v
        return t

    r_j = int(kf[j]) >> 48
    preds = {
        "num_rings": lambda c: ck.broken_num_rings(
            num_rings + (rings + 1 if c else 0), rings),
        "ring_id": lambda c: ck.broken_ring_id(
            with_(ring_id, i, rings + 3) if c else ring_id, valid,
            num_rings, rings),
        "pos": lambda c: ck.broken_pos(
            ring_id, with_(pos, i, -1) if c else pos, lay.counts,
            lay.overflow, rings, cap),
        "star_pid": lambda c: ck.broken_star_pid(
            with_(hp, 0, valid.shape[0] + 5) if c else hp, valid),
        "flood_window": lambda c: ck.broken_flood_window(
            with_(w, 1, -1.0) if c else w, lay.counts, num_rings),
        "marker_bin": lambda c: ck.broken_marker_bin(
            with_(lay.alpha, (0, 0), 400.0) if c else lay.alpha,
            lay.counts, num_rings),
        "marker_read": lambda c: ck.broken_marker_read(
            lay, num_rings, with_(kf, j, (r_j << 48) | int(
                lay.counts[r_j])) if c else kf, probe["markers"]),
        "gather_addr": lambda c: ck.broken_gather_addr(
            ring_id, with_(pos, i, -1) if c else pos, valid, rings, cap),
    }
    assert set(preds) == ck.INDEX_ERRORS, sorted(preds)
    for name, pred in preds.items():
        for corrupt in (False, True):
            word = ck._Word(frozenset([name]), dev)
            word.check(name, lambda: pred(corrupt))
            want = (1 << ck.CONTRACTS[name][0]) if corrupt else 0
            assert int(word.word) == want, (name, corrupt, int(word.word))
    print(f"  negative controls: each of the {len(preds)} contracts' bit set "
          f"by its corrupted tensor on the card, clear on the clean one",
          flush=True)
    return launches


def sync_calls(prof) -> int:
    """Host-blocking CUDA runtime calls in a profiler's trace."""
    from torch.autograd import DeviceType

    return sum(1 for e in prof.events() if e.device_type == DeviceType.CPU
               and e.name in ("cudaStreamSynchronize", "cudaEventSynchronize",
                              "cudaDeviceSynchronize"))


def phase_checked_replay(dev, smi) -> dict:
    """The harness in checked mode on the 3 PCD fixtures and 10 OS1-64
    drive scans, each beside the default harness: 0 errors, the topics
    equal field by field, and as many host-blocking calls per scan as the
    default (the error word rides the one synchronisation).  Returns the
    checked runs' launch counts."""
    import os

    from torch.profiler import ProfilerActivity, profile

    from urban_road_filter_torch import (
        FilterConfig, PipelineDims, launch_counts, reset_launch_counts)
    from urban_road_filter_torch.io import make_drive
    from urban_road_filter_torch.io.replay import (
        ReplayHarness, pcd_dir_source)

    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "fixtures")
    drive = list(make_drive(10, sensor="os1_64", seed=43))
    total = {}
    for what, source, dims in (
            ("fixtures", lambda: pcd_dir_source(fixtures),
             PipelineDims(16384, 64, 1024, 256)),
            ("OS1-64 drive", lambda: iter(drive),
             PipelineDims.for_sensor("os1-64"))):
        runs, syncs = {}, {}
        for checked in (False, True):
            got = []
            h = ReplayHarness(cfg=FilterConfig(), dims=dims, device=dev,
                              on_scan=got.append, checked=checked)
            h._warm_up()
            # A first run under a profiler: the compiled entry captures its
            # traced variant (a capture synchronises) before the count.
            with profile(activities=[ProfilerActivity.CPU]):
                ReplayHarness(cfg=FilterConfig(), dims=dims, device=dev,
                              checked=checked).run(source())
            torch.cuda.synchronize()
            reset_launch_counts()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                s = h.run(source()).summary()
            if checked:
                for k, v in launch_counts().items():
                    total[k] = total.get(k, 0) + v
            assert s["errors"] == 0 and s["not_ok"] == 0, (what, s)
            runs[checked], syncs[checked] = got, sync_calls(prof)
        same_outputs(runs[True], runs[False], f"checked replay, {what}")
        n = len(runs[True])
        assert syncs[True] == syncs[False], (what, syncs)
        print(f"  checked harness, {what}: {n} scans, 0 errors, topics equal "
              f"the default harness's field by field; "
              f"{syncs[True] / n:.1f} host-blocking CUDA calls a scan "
              f"(default {syncs[False] / n:.1f}) on {smi}", flush=True)
    return total


def phase_data_parallel(dev, cfg, scans, dims) -> dict:
    """make_sharded_pipeline over [cuda:0] and [cuda:0, cuda:0] on phase
    4's batch (planar): every field equal to process_batch's; two chunks
    make two ingest and two gather launches (each chunk a replay of
    process_batch_jit, its graph captured by a first run); a cfg_now swap
    of beam_zone makes no capture and equals process_batch under it.
    Returns the launch counts of the two-chunk run."""
    from urban_road_filter_torch import (
        launch_counts, pad_scan, planarize_batch, process_batch,
        reset_launch_counts)
    from urban_road_filter_torch.pipeline import CAPTURE_COUNTS
    from urban_road_filter_torch.parallel.data_parallel import (
        make_sharded_pipeline)

    pts = torch.from_numpy(planarize_batch(np.stack(
        [pad_scan(p, dims.max_points) for _, p in scans]))).to(dev)
    want = process_batch(pts, cfg, dims, layout="planar")
    for devices in ([dev], [dev, dev]):
        run = make_sharded_pipeline(devices, cfg, dims)
        run(pts, layout="planar")  # the chunks' captures
        torch.cuda.synchronize()
        reset_launch_counts()
        got = run(pts, layout="planar")
        torch.cuda.synchronize()
        launches = launch_counts()
        for f, g, w in zip(want._fields, got, want):
            try:
                max_abs_err((g,), (w,))
            except AssertionError as e:
                raise AssertionError(f"{len(devices)} devices, field {f}: "
                                     f"{e}") from None
        assert launches["ingest_prep"] == len(devices), launches
        assert launches["gather_pack"] == len(devices), launches
        captures = dict(CAPTURE_COUNTS)
        swap = cfg.replace(beam_zone=45.5)
        same_fields(run(pts, cfg_now=swap, layout="planar"),
                    process_batch(pts, swap, dims, layout="planar"),
                    f"{len(devices)} devices, beam_zone swapped")
        assert CAPTURE_COUNTS == captures, (captures, CAPTURE_COUNTS)
        print(f"  make_sharded_pipeline over {len(devices)} x {dev}: "
              f"{pts.shape[1]} lanes equal process_batch's, "
              f"{launches['ingest_prep']} ingest and "
              f"{launches['gather_pack']} gather launches; a beam_zone "
              f"swap without a capture", flush=True)
    return launches


def phase_trace(dev, dims, scan):
    """One packed_scan of a scan under profiling.device_trace: a trace file
    written; each launch of K1-K11 in a urf::k::<kernel> range whose host
    parent is its stage's urf::<stage> range, its kernel credited to that
    stage by utils.profiling.stage_device_time, whose stage windows on the
    device are disjoint and in pipeline order.  Prints each stage's device
    ms, its kernels included.  Returns the traced run's launch counts and
    the names of its device ops (H2D and D2H of the outputs included), a
    Counter."""
    import collections
    import glob
    import os
    import tempfile

    from torch.autograd import DeviceType

    from urban_road_filter_torch import (
        FilterConfig, launch_counts, pad_scan, packed_scan,
        reset_launch_counts)
    from urban_road_filter_torch.utils.profiling import (
        device_trace, stage_device_time)

    cfg = FilterConfig()
    host = torch.from_numpy(pad_scan(scan, dims.max_points)).pin_memory()
    for _ in range(2):
        [t.cpu() for t in packed_scan(host.to(dev), cfg, dims)]
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        reset_launch_counts()
        with device_trace(tmp) as prof:
            [t.cpu() for t in packed_scan(host.to(dev, non_blocking=True),
                                          cfg, dims)]
        launches = launch_counts()
        files = glob.glob(os.path.join(tmp, "*.json"))
        assert len(files) == 1 and os.path.getsize(files[0]) > 0, files
    events = prof.events()
    ops = collections.Counter(
        e.name for e in events if e.device_type == DeviceType.CUDA
        and not e.name.startswith("urf::"))
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith("urf::k::"):
            parent = e.cpu_parent and e.cpu_parent.name
            assert parent == f"urf::{STAGE_OF[e.name[8:]]}", (e.name, parent)
    stages = stage_device_time(events)
    lost = {st: rec["unmatched"] for st, rec in stages.items()
            if rec["unmatched"]}
    assert not lost, f"ranges without a device projection: {lost}"
    for name in SCAN_KERNELS:
        us, count = stages[STAGE_OF[name]]["kernels"].get(name, (0.0, 0))
        assert count == launches[name] > 0 and us > 0, (name, us, count)
    order = [w for st in dict.fromkeys(STAGE_OF.values())
             for w in stages[st]["windows"]]
    assert order == sorted(order) and all(
        a[1] <= b[0] for a, b in zip(order, order[1:])), order
    print(f"  device_trace of one packed_scan: a trace file written; every "
          f"launch of K1-K11 inside its stage's range on the host and in its "
          f"stage's window on the device, the windows disjoint and in "
          f"pipeline order; {sum(ops.values())} device ops (H2D and D2H "
          f"included)", flush=True)
    for stage, rec in stages.items():
        ks = ", ".join(f"{k} {us / 1e3:.4f}"
                       for k, (us, _) in rec["kernels"].items())
        print(f"    stage {stage}: {rec['device_us'] / 1e3:.4f} ms device, "
              f"{rec['ops']} ops; kernels (ms): {ks or 'none'}", flush=True)
    return launches, ops


def trace_child() -> None:
    """phase_trace on the first OS1-64 drive scan, as a fresh process
    (``python3 -c "import chip_smoke; chip_smoke.trace_child()"``): its
    last line is {"launches": ..., "ops": {name: count}}."""
    from urban_road_filter_torch import PipelineDims

    launches, ops = phase_trace(torch.device("cuda", 0),
                                PipelineDims.for_sensor("os1-64"),
                                scans_for_pipeline()[-2][1])
    print(json.dumps({"launches": launches, "ops": ops}))


def phase_traces() -> dict:
    """phase_trace in a fresh process, where packed_scan's device ops must
    be SCAN_DEVICE_OPS (tools/profile_torch_scan.py counts them in a fresh
    process too: after phases 1-7 in this one, the profiler has lost an
    event of the traced scan).  Returns its launch counts."""
    import os

    out = subprocess.run(
        [sys.executable, "-c",
         "import chip_smoke; chip_smoke.trace_child()"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600)
    print(out.stdout.rsplit("\n", 2)[0], flush=True)
    assert out.returncode == 0, out.stderr[-3000:]
    fresh = json.loads(out.stdout.strip().splitlines()[-1])
    n_ops = sum(fresh["ops"].values())
    assert n_ops == SCAN_DEVICE_OPS, (n_ops, fresh["ops"])
    return fresh["launches"]


def phase_demo(dev) -> dict:
    """examples/demo_torch.py on the card at --render-every 0: 4 scans, the
    beam_zone hot swap at scan 1 (no capture: the harness's graph of its
    first scan is replayed with the new value), no error.  Returns its
    launch counts."""
    import contextlib
    import importlib.util
    import io
    import os

    from urban_road_filter_torch import launch_counts, reset_launch_counts
    from urban_road_filter_torch import pipeline as pl

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "demo_torch.py")
    keys, captures = set(pl.compiled_entries()), pl.CAPTURE_COUNTS["packed"]
    spec = importlib.util.spec_from_file_location("demo_torch", path)
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    out = io.StringIO()
    torch.cuda.synchronize()
    reset_launch_counts()
    with contextlib.redirect_stdout(out):
        demo.main(["--device", str(dev), "--render-every", "0", "--scans",
                   "4", "--swap-at", "1"])
    torch.cuda.synchronize()
    launches = launch_counts()
    lines = out.getvalue().splitlines()
    summary = json.loads(lines[-1])
    assert "# hot-swapped beam_zone -> 50.0 at scan 1" in lines, lines
    assert summary["scans"] == 4 and summary["errors"] == 0, summary
    new = set(pl.compiled_entries()) - keys
    added = pl.CAPTURE_COUNTS["packed"] - captures
    assert added == len(new) <= 1, (added, new)
    print(f"  examples/demo_torch.py: 4 scans on {dev}, beam_zone hot-swapped "
          f"at scan 1, 0 errors, {added} capture (the swap none), latency "
          f"p50 {summary['latency_ms']['p50']} ms", flush=True)
    return launches


RANK_TIMEOUT_S = 180  # a phase-8 collective that waits longer ends its rank
RANKS_LIMIT_S = 300  # every phase-8 rank reports and exits within this


def ranked_runs(dev, group, data, configs) -> dict:
    """make_azimuth_pipeline(8 wedges, group=group) on phase 5's two
    deployments in each configuration, host to host (the padded scan from
    pinned memory, every field back).  Where the group's run is compiled
    (NCCL), ``run`` and ``run.eager`` in turns, SP_PAIRS pairs after one
    call of each (the capture), and on a one-rank group the one-card
    compiled run (make_azimuth_pipeline(8) with no group) as a third mode
    in the same turns; else ``run.eager``, 1 + SCAN_REPS calls.  Returns
    per mode the launch counts of its timed calls (the counters zeroed
    just before each call and read just after), the counts those calls
    should make (sp_per_scan) and their number; each mode's p50, each
    run's eager census, the (deployment, configuration,
    mode, field) that differ bitwise from the one-card results in
    ``data``, the runs after whose calls the census differed from eager's,
    each run's (captures, entries) and graph stats; where compiled, also
    each default run's (swaps that differ from run.eager, captures they
    made) over the 15 dynamic swaps and all at once, and the calls that
    synchronised under torch.cuda.set_sync_debug_mode("error"); on rank 0
    the labels and markers, for the oracle gate; where compiled, each
    default run's device busy ms, busy share and device ops a scan, eager
    and compiled (device_busy, in turns)."""
    import torch.distributed as dist

    from urban_road_filter_torch import (
        FilterConfig, ScanResult, launch_counts, reset_launch_counts)
    from urban_road_filter_torch import pipeline as pl
    from urban_road_filter_torch.parallel.azimuth_parallel import (
        make_azimuth_pipeline)

    def census(run):
        return {k: dict(v) for k, v in run.wedges.census.items()}

    out = {"launches": {}, "want": {}, "calls": {}, "p50": {}, "census": {},
           "differ": [], "census_differ": [], "captures": {}, "stats": {},
           "swaps": {}, "synced": [], "busy": {}, "gate": {},
           "compiled": False}
    for name, dims in sp_dims().items():
        host = torch.from_numpy(data[f"pts/{name}"]).pin_memory()
        for cname, cfg in configs.items():
            run = make_azimuth_pipeline(WEDGES, cfg, dims, device=dev,
                                        group=group)
            out["compiled"] = compiled = run is not run.eager
            modes = ({"eager": run.eager, "compiled": run} if compiled
                     else {"eager": run.eager})
            if compiled and dist.get_world_size(group) == 1:
                modes["one card"] = make_azimuth_pipeline(WEDGES, cfg, dims,
                                                          device=dev)
                modes["one card"](host.to(dev))  # its capture
            ref = [torch.from_numpy(data[f"ref/{name}/{cname}/{f}"])
                   for f in ScanResult._fields]
            per_scan = sp_per_scan(run.wedges.local, cfg.star_shaped_method)
            before = pl.CAPTURE_COUNTS["sp"]
            for fn in (run.eager, run):  # the warm-up, and the capture
                fn(host.to(dev, non_blocking=True))
            torch.cuda.synchronize()
            times = {m: [] for m in modes}
            censuses = []
            for p in range(SP_PAIRS if compiled else SCAN_REPS):
                for m in (list(modes) if p % 2 == 0 else list(modes)[::-1]):
                    reset_launch_counts()
                    t0 = time.perf_counter()
                    res = modes[m](host.to(dev, non_blocking=True))
                    fetched = ScanResult(*(t.cpu() for t in res))
                    times[m].append(time.perf_counter() - t0)
                    seen, due = (out[k].setdefault(m, {})
                                 for k in ("launches", "want"))
                    for k, v in launch_counts().items():
                        seen[k] = seen.get(k, 0) + v
                    for k, v in per_scan.items():
                        due[k] = due.get(k, 0) + v
                    out["calls"][m] = out["calls"].get(m, 0) + 1
                    if m != "one card":
                        censuses.append(census(run))
                    out["differ"] += [
                        (name, cname, m, f) for f, got, want in zip(
                            ScanResult._fields, fetched, ref)
                        if not same_bits(got, want)]
                    if m == "compiled" or not compiled:
                        gate = (fetched.labels.numpy(),
                                fetched.markers.numpy())
            for m, tt in times.items():
                out["p50"][name, cname, m] = statistics.median(tt) * 1e3
            run.eager(host.to(dev))
            out["census"][name, cname] = census(run)
            if any(c != out["census"][name, cname] for c in censuses):
                out["census_differ"].append((name, cname))
            out["captures"][name, cname] = (pl.CAPTURE_COUNTS["sp"] - before,
                                            len(run.entries))
            for e in run.entries.values():
                out["stats"][name, cname] = e.stats
            if dist.get_rank(group) == 0:
                out["gate"][name, cname] = gate
            if not compiled or cname != "default":
                continue
            # Device busy and ops a scan, in turns; the hot swaps; the
            # synchronising calls.
            for m in ("eager", "compiled", "compiled", "eager"):
                out["busy"][name, m] = device_busy(lambda: [
                    modes[m](host.to(dev, non_blocking=True))
                    for _ in range(SP_CALLS)], SP_CALLS)
            pts = host.to(dev)
            before = pl.CAPTURE_COUNTS["sp"]
            differ = []
            for field, val in [*DYN_SWAPS.items(), ("all", None)]:
                swap = FilterConfig(**(DYN_SWAPS if val is None
                                       else {field: val}))
                if not all(map(same_bits, run(pts, swap),
                               run.eager(pts, swap))):
                    differ.append(field)
            out["swaps"][name] = (differ, pl.CAPTURE_COUNTS["sp"] - before)
            calls = {"eager": lambda: run.eager(pts),
                     "compiled": lambda: run(pts),
                     "compiled, hot swap": lambda: run(
                         pts, FilterConfig(beam_zone=42.5))}
            torch.cuda.synchronize()
            for what, fn in calls.items():
                torch.cuda.set_sync_debug_mode("error")
                try:
                    fn()
                except RuntimeError as e:
                    out["synced"].append((name, what, str(e)[:200]))
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
    return out


def sp_harness_scans() -> list:
    """Phase 8 (b)'s harness scans: two OS1-128 drive scans (phase 6 (c)'s
    first two)."""
    from urban_road_filter_torch.io import make_drive
    from urban_road_filter_torch.parallel.azimuth_parallel import (
        azimuth_sorted)

    return [azimuth_sorted(p) for p in make_drive(2, sensor="os1_128",
                                                  seed=31, firings=2048)]


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.cpu(), b.cpu()
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.numpy().tobytes() == b.numpy().tobytes())


def ticket_check(dev, data) -> bool:
    """K1 (a TICKETED kernel: per-device block tickets) 20 times in a row
    on the OS1-128 scan, while the other ranks on the card do the same
    from their own contexts: every call equal to the first, and the first
    to the plain twin's outputs on the CPU."""
    import torch.distributed as dist

    from urban_road_filter_torch import FilterConfig
    from urban_road_filter_torch.ops import ingest

    pts = torch.from_numpy(data["pts/os1_128_262k"])
    xyz = [pts[None, :, k].contiguous() for k in range(3)]
    cfg = FilterConfig()
    want = ingest.ingest_prep(*xyz, cfg, want_star_keys=True)
    on_card = [t.to(dev) for t in xyz]
    dist.barrier()
    got = [ingest.ingest_prep(*on_card, cfg, want_star_keys=True)
           for _ in range(20)]
    return all(same_bits(a, b) for call in got for a, b in zip(call, want))


def sp_rank(rank: int, world: int, backend: str, store: str, data_path: str,
            configs: dict, q) -> None:
    """One rank of phase 8 (b) or (c), a process of its own: NCCL on
    cuda:<rank>, gloo on cuda:0 with every other rank.  Puts (rank,
    results) on q: ranked_runs' results, in (b) the ticket check, and
    the SP harness over the ranks (rank 0 replays phase 6's OS1-128 scans,
    the others follow) with the captures it made on this rank; a failure
    puts its traceback under "error"."""
    import datetime
    import traceback

    import torch.distributed as dist

    out = {}
    try:
        from urban_road_filter_torch import FilterConfig
        from urban_road_filter_torch import pipeline as pl
        from urban_road_filter_torch.io.replay import ReplayHarness, follow

        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, store=dist.FileStore(store, world), rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
        group = dist.group.WORLD
        data = np.load(data_path)
        out = ranked_runs(dev, group, data, configs)
        if backend == "gloo":
            out["tickets_ok"] = ticket_check(dev, data)
        dims = sp_dims()["os1_128_262k"]
        before = pl.CAPTURE_COUNTS["sp"]
        if rank == 0:
            out["harness"] = sp_harness(dev, group, dims, data)
        else:
            out["followed"] = follow(FilterConfig(), dims, WEDGES, group,
                                     device=dev)
        out["harness_captures"] = pl.CAPTURE_COUNTS["sp"] - before
        assert_no_jax()
    except Exception:  # noqa: BLE001 -- reported to the parent
        out["error"] = traceback.format_exc()
    finally:
        q.put((rank, out))
        if dist.is_initialized():
            dist.destroy_process_group()


def sp_harness(dev, group, dims, data) -> list:
    """Rank 0 of the SP harness over the group: phase 8's harness scans
    (the other ranks follow); returns the published topics."""
    from urban_road_filter_torch import FilterConfig
    from urban_road_filter_torch.io.replay import ReplayHarness

    got = []
    h = ReplayHarness(cfg=FilterConfig(), dims=dims, azimuth_shard=WEDGES,
                      device=dev, group=group, on_scan=got.append)
    try:
        m = h.run(iter(data[f"harness/{k}"] for k in range(
            int(data["harness_scans"]))))
    finally:
        h.close()
    assert m.summary()["errors"] == 0, m.last_error
    return got


def spawn_ranks(world: int, backend: str, tmp: str, data_path: str,
                configs: dict) -> dict:
    """sp_rank on ``world`` spawned processes; {rank: results}, after
    every rank reported and exited within RANKS_LIMIT_S (a straggler is
    ended); any rank's failure raises."""
    import os
    import queue

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = os.path.join(tmp, f"store_{backend}_{world}")
    procs = [ctx.Process(target=sp_rank, args=(r, world, backend, store,
                                               data_path, configs, q),
                         daemon=True) for r in range(world)]
    deadline = time.monotonic() + RANKS_LIMIT_S
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < world:
            try:
                rank, res = q.get(timeout=max(1.0,
                                              deadline - time.monotonic()))
            except queue.Empty:
                raise AssertionError(
                    f"ranks {sorted(set(range(world)) - set(got))} did not "
                    f"report within {RANKS_LIMIT_S} s") from None
            got[rank] = res
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    for rank, res in sorted(got.items()):
        assert "error" not in res, f"rank {rank}:\n{res['error']}"
    assert [p.exitcode for p in procs] == [0] * world, [
        p.exitcode for p in procs]
    return got


def check_ranked(what: str, ranked: dict, deployments, configs,
                 device_parity_gate) -> None:
    """Every rank bit-equal to the one-card run on every field; on every
    rank and in each mode, every kernel of the SP path launched and each
    kernel's launches exactly sp_per_scan's over that mode's calls; the
    census alike on every rank and after every call, rank 0's results
    gated against the oracle.  Where the run is compiled: one capture and
    one entry per run, each of the 15 dynamic swaps equal to run.eager
    with no capture, and no synchronising call."""
    for rank, res in sorted(ranked.items()):
        assert not res["differ"], (what, rank, res["differ"][:5])
        assert not res["census_differ"], (what, rank, res["census_differ"])
        assert set(res["launches"]) >= (
            {"eager", "compiled"} if res["compiled"] else {"eager"}), (
                what, rank, set(res["launches"]))
        for m, got in res["launches"].items():
            assert_launched(got, SP_KERNELS, f"{what} rank {rank} {m}")
            want = res["want"][m]
            assert all(got.get(k, 0) == want.get(k, 0)
                       for k in {*got, *want}), (what, rank, m, got, want)
        assert res["census"] == ranked[0]["census"], (what, rank)
        assert res["compiled"] == ranked[0]["compiled"], (what, rank)
        if res["compiled"]:
            assert set(res["captures"].values()) == {(1, 1)}, (
                what, rank, res["captures"])
            assert res["swaps"] and all(
                v == ([], 0) for v in res["swaps"].values()), (
                    what, rank, res["swaps"])
            assert not res["synced"], (what, rank, res["synced"])
        else:
            assert set(res["captures"].values()) == {(0, 0)}, (what, rank)
    for name, _, scan, channels in deployments:
        for cname, cfg in configs.items():
            labels, markers = ranked[0]["gate"][name, cname]
            agree, n_sys = device_parity_gate(scan, labels, markers, cfg,
                                              name, channels=channels)
            assert agree >= 0.999 and n_sys == 0, (what, name, cname, agree,
                                                   n_sys)


def phase_ranks(dev, configs, smi, device_parity_gate) -> None:
    """Phase 8: the SP path over the ranks of a process group, 8 wedges,
    on phase 5's deployments, beside make_azimuth_pipeline(8) on one card
    (p50s in this call): (a) a one-rank NCCL group in this process, its
    run compiled against run.eager, and the SP harness over it; (b) 8 gloo
    ranks of one wedge each, spawned on cuda:0, op by op (with K1's
    tickets under 8 contexts and the SP harness over the ranks); (c) NCCL
    over min(cards, 8) ranks, a power of two, compiled against run.eager,
    where there are 2 cards or more."""
    import os
    import tempfile

    import torch.distributed as dist

    from urban_road_filter_torch import FilterConfig, ScanResult, pad_scan
    from urban_road_filter_torch import pipeline as pl
    from urban_road_filter_torch.io.replay import ReplayHarness
    from urban_road_filter_torch.parallel.azimuth_parallel import (
        make_azimuth_pipeline)

    deployments = sp_deployments()
    data = {}
    one_p50 = {}
    for name, dims, scan, _ in deployments:
        pts = pad_scan(scan, dims.max_points)
        data[f"pts/{name}"] = pts
        host = torch.from_numpy(pts).pin_memory()
        for cname, cfg in configs.items():
            # The one-card reference, op by op (phase 10 replays its
            # graph).
            run = make_azimuth_pipeline(WEDGES, cfg, dims, device=dev).eager
            times = []
            for _ in range(1 + SCAN_REPS):
                t0 = time.perf_counter()
                fetched = ScanResult(*(t.cpu() for t in run(
                    host.to(dev, non_blocking=True))))
                times.append(time.perf_counter() - t0)
            one_p50[name, cname] = statistics.median(times[1:]) * 1e3
            for f in ScanResult._fields:
                data[f"ref/{name}/{cname}/{f}"] = getattr(fetched, f).numpy()
    hdims = sp_dims()["os1_128_262k"]
    hscans = sp_harness_scans()
    for k, scan in enumerate(hscans):
        data[f"harness/{k}"] = scan
    data["harness_scans"] = np.int32(len(hscans))
    want_topics = []
    ReplayHarness(cfg=FilterConfig(), dims=hdims, azimuth_shard=WEDGES,
                  device=dev, on_scan=want_topics.append).run(iter(hscans))

    with tempfile.TemporaryDirectory() as tmp:
        data_path = os.path.join(tmp, "phase8.npz")
        np.savez(data_path, **data)
        ref = np.load(data_path)

        # (a) One NCCL rank holding all 8 wedges, in this process: run (a
        # CUDA-graph replay, the collectives inside) against run.eager in
        # turns, then the SP harness over the group, replaying.
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store_a"), 1),
            rank=0, world_size=1)
        try:
            a = ranked_runs(dev, dist.group.WORLD, ref, configs)
            before = pl.CAPTURE_COUNTS["sp"]
            topics = sp_harness(dev, dist.group.WORLD, hdims, ref)
            harness_captures = pl.CAPTURE_COUNTS["sp"] - before
        finally:
            dist.destroy_process_group()
        assert a["compiled"], "(a): the NCCL group's run is not compiled"
        check_ranked("(a)", {0: a}, deployments, configs,
                     device_parity_gate)
        assert set(a["calls"]) == {"eager", "compiled", "one card"}
        same_outputs(topics, want_topics, "(a) SP harness")
        assert harness_captures == 1, harness_captures
        census = a["census"]["os1_128_262k", "default"]
        print(f"  collective census per SP scan, OS1-128 production dims "
              f"(262144 points, 128 rings x 384 slots a wedge, 8 wedges): "
              + ", ".join(f"{k} {v['calls']} calls {v['bytes']} B"
                          for k, v in sorted(census.items()))
              + f", {sum(v['bytes'] for v in census.values())} B in all "
              f"(received per rank)", flush=True)
        for (name, cname), st in a["stats"].items():
            print(f"  (a) graph {name} {cname} over the one-rank NCCL group:"
                  f" nodes {st['nodes']}, capture {st['capture_ms']:.3f} ms,"
                  f" instantiate {st['instantiate_ms']:.3f} ms, pool "
                  f"{st['pool_bytes']} B", flush=True)
        for (name, m), (busy, share, ops) in a["busy"].items():
            print(f"  (a) {name} default {m} over the one-rank NCCL group: "
                  f"device busy {busy:.4f} ms a scan ({100 * share:.1f} % "
                  f"of the profiled wall), {ops:.1f} device ops a scan "
                  f"(the second pass of the two in turns); on {smi}",
                  flush=True)
        print(f"  (a) one NCCL rank: every field of run and run.eager "
              f"bit-equal to make_azimuth_pipeline(8) on one card, "
              f"{SP_PAIRS} pairs in turns a run; each mode's launches "
              f"exactly its calls' (eager {a['calls']['eager']}, compiled "
              f"{a['calls']['compiled']}, one card compiled "
              f"{a['calls']['one card']} calls: "
              f"{ {k: v for k, v in a['launches']['compiled'].items() if v} }"
              f" compiled); one capture a key; "
              f"{len(DYN_SWAPS)} dynamic swaps and all at once equal to "
              f"run.eager with no capture; the census after every replay "
              f"eager's; no synchronising call (eager, compiled, hot swap); "
              f"oracle gate passed; the SP harness over the group made one "
              f"capture and published the one-card SP harness's topics on "
              f"{len(hscans)} OS1-128 scans", flush=True)

        # (b) 8 gloo ranks of one wedge each, all on cuda:0.
        t0 = time.perf_counter()
        b = spawn_ranks(WEDGES, "gloo", tmp, data_path, configs)
        took = time.perf_counter() - t0
        assert not b[0]["compiled"], "(b): a gloo group's run on the card"
        check_ranked("(b)", b, deployments, configs, device_parity_gate)
        assert all(res["tickets_ok"] for res in b.values()), "K1 tickets"
        for res in b.values():
            assert res["census"] == a["census"]
            assert res["harness_captures"] == 0
        assert all(res["followed"] == len(hscans)
                   for r, res in b.items() if r)
        same_outputs(b[0]["harness"], want_topics, "(b) SP harness")
        for name, dims, _, _ in deployments:
            for cname in configs:
                print(f"  {name} {cname}: SP p50 host to host on {smi}: "
                      f"one card, op by op {one_p50[name, cname]:.3f} ms; "
                      f"(a) one NCCL rank, compiled "
                      f"{a['p50'][name, cname, 'compiled']:.3f} ms, op by op "
                      f"{a['p50'][name, cname, 'eager']:.3f} ms, beside one "
                      f"card compiled "
                      f"{a['p50'][name, cname, 'one card']:.3f} ms "
                      f"({SP_PAIRS} rounds of the three in turns); (b) 8 gloo ranks on cuda:0, op by "
                      f"op (a correctness run: gloo stages every collective "
                      f"through the host) "
                      f"{b[0]['p50'][name, cname, 'eager']:.3f} ms at rank "
                      f"0, {max(r['p50'][name, cname, 'eager'] for r in b.values()):.3f}"
                      f" ms at the slowest rank", flush=True)
        print(f"  (b) gloo ranks on the card run op by op (run is "
              f"run.eager): every field of every rank bit-equal to "
              f"make_azimuth_pipeline(8) on one card, oracle gate passed; "
              f"{took:.1f} s with the spawn, every rank launched "
              f"{', '.join(SP_KERNELS)}; K1 20 calls a rank under 8 "
              f"contexts equal to its plain twin; the SP harness over the "
              f"8 ranks published the one-card SP harness's topics on "
              f"{len(hscans)} OS1-128 scans", flush=True)
        print(f"    launches at rank 0 (b), {b[0]['calls']['eager']} calls: "
              f"{ {k: v for k, v in b[0]['launches']['eager'].items() if v} }")

        # (c) NCCL over several cards, compiled beside run.eager.
        cards = torch.cuda.device_count()
        if cards < 2:
            print(f"phase 8 (c) not run: {cards} card", flush=True)
        else:
            world = 1 << (min(cards, WEDGES).bit_length() - 1)
            c = spawn_ranks(world, "nccl", tmp, data_path, configs)
            assert c[0]["compiled"], "(c): the NCCL ranks' run"
            check_ranked("(c)", c, deployments, configs, device_parity_gate)
            assert all(res["harness_captures"] == 1 for res in c.values())
            assert all(res["followed"] == len(hscans)
                       for r, res in c.items() if r)
            same_outputs(c[0]["harness"], want_topics, "(c) SP harness")
            for name, dims, _, _ in deployments:
                for cname in configs:
                    p50 = c[0]["p50"]
                    print(f"  (c) {name} {cname}: SP p50 host to host over "
                          f"{world} NCCL ranks at rank 0, compiled "
                          f"{p50[name, cname, 'compiled']:.3f} ms, op by op "
                          f"{p50[name, cname, 'eager']:.3f} ms; graph "
                          f"{c[0]['stats'][name, cname]['nodes']}",
                          flush=True)


# ---- phase 9: the compiled entry points (CUDA-graph replays) ----

# One new value for each of the 15 dynamic fields (config.DynConfig; cos_x,
# cos_z and slope_param through the three angles).
DYN_SWAPS = dict(interval=0.3, curb_height=0.11, beam_zone=42.5, min_x=1.0,
                 max_x=25.0, min_y=-8.0, max_y=8.0, min_z=-2.8, max_z=-1.2,
                 cylinder_deg_x=140.0, cylinder_deg_z=130.0,
                 curb_slope_deg=45.0, kdev_param=1.5, kdist_param=3.0,
                 dmin_param=8)


def same_fields(got, want, what: str) -> None:
    """Two results (ScanResult or tuple) bit-equal field by field."""
    assert len(got) == len(want), what
    for k, (g, w) in enumerate(zip(got, want)):
        try:
            max_abs_err((g,), (w,))
        except AssertionError as e:
            raise AssertionError(f"{what}, field {k}: {e}") from None


def jit_lanes(dev, planar, dims, cfg, what: str) -> None:
    """process_batch_jit of a planar batch bit-equal on every field to
    process_scan_jit of each lane, and its packed planes, markers, gates,
    ring counts and overflows to packed_scan_jit's."""
    from urban_road_filter_torch import (
        packed_scan_jit, process_batch_jit, process_scan_jit)

    got = process_batch_jit(planar, cfg, dims, layout="planar", device=dev)
    for b in range(planar.shape[1]):
        lane = planar[:, b]
        same_fields([f[b] for f in got],
                    process_scan_jit(lane, cfg, dims, layout="planar",
                                     device=dev),
                    f"process_batch_jit lane {b} vs process_scan_jit")
        packed = (got.labels[b].to(torch.uint8) | (got.roi[b].to(
            torch.uint8) << 2) | (got.probably_road[b].to(torch.uint8) << 3))
        same_fields((packed, got.markers[b], got.ok[b], got.num_rings[b],
                     got.overflow[b]),
                    packed_scan_jit(lane, cfg, dims, layout="planar",
                                    device=dev),
                    f"process_batch_jit lane {b} vs packed_scan_jit")
    print(f"  (b) process_batch_jit on {what} ({planar.shape[1]} lanes) "
          f"bit-equal on every field to process_scan_jit and "
          f"packed_scan_jit lane by lane", flush=True)


def replay_topics(dev, source, dims, cfg, swap_at=None):
    """The harness's published outputs over a source, with h.cfg's
    beam_zone swapped to 50 after scan ``swap_at`` (the demo's swap)."""
    from urban_road_filter_torch.io.replay import ReplayHarness

    got = []

    def on_scan(out):
        got.append(out)
        if swap_at is not None and out.seq == swap_at:
            h.cfg = h.cfg.replace(beam_zone=50.0)

    h = ReplayHarness(cfg=cfg, dims=dims, device=dev, on_scan=on_scan)
    s = h.run(source).summary()
    assert s["errors"] == 0 and s["not_ok"] == 0, s
    return got


def phase_compiled(dev, dims, bench_dims, configs, scans, bench, smi,
                   gate_scans) -> dict:
    """The compiled entry points on the card (pipeline.*_jit): (a) phase
    3's 9 scans under every configuration through packed_scan_jit and
    process_scan_jit, bit-equal to packed_scan and process_scan, gated; (b)
    phase 4's batch through process_batch_jit, bit-equal to process_batch;
    (c) the harness (its default path is packed_scan_jit) on the 3 PCD
    fixtures with the demo's beam_zone swap after the first scan: no new
    capture, the topics equal an eager harness's; (d) each of the 15
    dynamic fields swapped in turn, then all at once: no capture, every
    output equal to the eager entry points' under the new configuration,
    max_x=12 changing the labels; a static swap, exactly one capture; (e)
    launch_counts credits each kernel of a graph once per launch it holds,
    per replay; (f) phase 4's batch from pinned host memory, as the replay
    cell hands it (the lane-group entry, pipeline._LaneGroups), bit-equal
    to process_batch, and over its replays LANE_GROUP_COPIES one call of
    ceil(B / LANE_GROUP) groups each, every batch kernel (K11 too) once
    per group; (g) under torch.cuda.set_sync_debug_mode("error") the eager
    and compiled scan, packed and batch paths (the pinned batch too) make
    no synchronising call.
    Prints each graph's kernel, memcpy and memset nodes, capture and
    instantiation ms and pool bytes.  Returns (f)'s launch counts."""
    import os

    from urban_road_filter_torch import (
        FilterConfig, PipelineDims, launch_counts, pad_scan, packed_scan,
        packed_scan_jit, planarize_batch, process_batch, process_batch_jit,
        process_scan, process_scan_jit, reset_launch_counts)
    from urban_road_filter_torch import pipeline as pl
    from urban_road_filter_torch.io import replay as replay_mod
    from urban_road_filter_torch.io.replay import pcd_dir_source

    hosts = [torch.from_numpy(pad_scan(p, dims.max_points)).pin_memory()
             for _, p in scans]
    every = dict(configs, stencils_off=FilterConfig(
        x_zero_method=False, z_zero_method=False))

    # (a) The 9 scans, every configuration of phase 3 (the stencils off on
    # its three scenes).
    runs = []
    for cname, cfg in every.items():
        for k, host in enumerate(hosts):
            if cname == "stencils_off" and scans[k][0] not in (
                    "two_curbs", "blind_spot", "curb_gap"):
                continue
            pts = host.to(dev, non_blocking=True)
            got = packed_scan_jit(pts, cfg, dims, device=dev)
            same_fields(got, packed_scan(pts, cfg, dims, device=dev),
                        f"packed_scan_jit {cname} {scans[k][0]}")
            same_fields(process_scan_jit(pts, cfg, dims, device=dev),
                        process_scan(pts, cfg, dims, device=dev),
                        f"process_scan_jit {cname} {scans[k][0]}")
            runs.append((cname, k, [t.cpu() for t in got], 0.0))
    gate_scans(runs, scans, every)
    print(f"  (a) {len(runs)} scans x (packed_scan_jit, process_scan_jit) "
          f"bit-equal to packed_scan / process_scan, every one gated",
          flush=True)

    # (b) The batch of 128.
    planar = torch.from_numpy(planarize_batch(np.stack(
        [pad_scan(p, bench_dims.max_points) for _, p in bench]))).to(dev)
    for cfg in (FilterConfig(), FilterConfig(beam_zone=45.5)):
        same_fields(process_batch_jit(planar, cfg, bench_dims,
                                      layout="planar", device=dev),
                    process_batch(planar, cfg, bench_dims, layout="planar",
                                  device=dev),
                    "process_batch_jit")
    print(f"  (b) process_batch_jit on {planar.shape[1]} planar scans "
          f"bit-equal to process_batch (default and beam_zone 45.5)",
          flush=True)
    jit_lanes(dev, planar, bench_dims, FilterConfig(), "the bench batch")
    mixed = torch.from_numpy(planarize_batch(np.stack(
        [pad_scan(p, bench_dims.max_points) for _, p in scans]))).to(dev)
    for cname, cfg in (("star on", FilterConfig()),
                       ("star off", FilterConfig(star_shaped_method=False))):
        jit_lanes(dev, mixed, bench_dims, cfg, f"the 9 scenes, {cname}")

    # (c) The harness on the fixtures, the demo's swap after scan 1.
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "fixtures")
    fdims = PipelineDims(16384, 64, 1024, 256)
    replay_topics(dev, pcd_dir_source(fixtures), fdims, FilterConfig())
    before = dict(pl.CAPTURE_COUNTS)
    got = replay_topics(dev, pcd_dir_source(fixtures), fdims, FilterConfig(),
                        swap_at=1)
    assert pl.CAPTURE_COUNTS == before, (before, pl.CAPTURE_COUNTS)
    compiled = replay_mod.packed_scan_jit
    replay_mod.packed_scan_jit = packed_scan  # an eager harness
    try:
        want = replay_topics(dev, pcd_dir_source(fixtures), fdims,
                             FilterConfig(), swap_at=1)
    finally:
        replay_mod.packed_scan_jit = compiled
    same_outputs(got, want, "the harness through packed_scan_jit")
    print(f"  (c) the harness on the 3 fixtures, beam_zone swapped to 50 "
          f"after scan 1: no new capture, topics equal the eager harness's",
          flush=True)

    # (d) Hot swaps on one scan, each kind.
    from urban_road_filter_torch.config import DynConfig

    swaps = DYN_SWAPS
    assert len(swaps) == len(DynConfig._fields)  # cos_x, cos_z, slope
    pts = hosts[1].to(dev)
    lanes = planar[:, :8].contiguous()
    kinds = {"scan": (process_scan_jit, process_scan, pts, dims,
                      dict(device=dev)),
             "packed": (packed_scan_jit, packed_scan, pts, dims,
                        dict(device=dev)),
             "batch": (process_batch_jit, process_batch, lanes, bench_dims,
                       dict(layout="planar", device=dev))}
    for kind, (jit, eager, x, d, kw) in kinds.items():
        base = jit(x, FilterConfig(), d, **kw)
        before = dict(pl.CAPTURE_COUNTS)
        for name, val in [*swaps.items(), ("all", None)]:
            cfg = (FilterConfig(**swaps) if name == "all"
                   else FilterConfig(**{name: val}))
            same_fields(jit(x, cfg, d, **kw), eager(x, cfg, d, **kw),
                        f"{kind} after the {name} swap")
        assert pl.CAPTURE_COUNTS == before, (kind, before, pl.CAPTURE_COUNTS)
        tight = jit(x, FilterConfig(max_x=12.0), d, **kw)
        lab = (lambda r: r[0] & 3) if kind == "packed" else (
            lambda r: r.labels)
        assert not torch.equal(lab(tight), lab(base)), kind
        jit(x, FilterConfig(x_direction=1), d, **kw)
        assert pl.CAPTURE_COUNTS[kind] == before[kind] + 1, kind
    print(f"  (d) {len(swaps)} dynamic fields swapped in turn and all at "
          f"once on scan, packed and batch (8 lanes): no capture, outputs "
          f"equal the eager entry points'; max_x=12 changes the labels; a "
          f"static swap (x_direction=1) one capture each", flush=True)

    # (e) Launches credited per replay.
    reps = 5
    torch.cuda.synchronize()
    reset_launch_counts()
    for _ in range(reps):
        packed_scan_jit(pts, FilterConfig(), dims, device=dev)
        process_batch_jit(planar, FilterConfig(), bench_dims,
                          layout="planar", device=dev)
    launches = launch_counts()
    b = planar.shape[1]
    for k in SCAN_KERNELS:  # one per scan and one per batch (K11 per 128)
        per = 1 + (-(-b // 128) if k == "gather_pack" else 1)
        assert launches[k] == reps * per, (k, launches[k], reps * per)
    print(f"  (e) {reps} replays each of packed_scan_jit and "
          f"process_batch_jit (B = {b}): launches {launches}", flush=True)

    # (f) The batch from pinned host memory, as the replay cell hands it:
    # the lane-group entry (pipeline._LaneGroups), each group's body after
    # its group's copy.
    pinned = planar.cpu().pin_memory()
    for cfg in (FilterConfig(), FilterConfig(beam_zone=45.5)):
        same_fields(process_batch_jit(pinned, cfg, bench_dims,
                                      layout="planar", device=dev),
                    process_batch(planar, cfg, bench_dims, layout="planar",
                                  device=dev),
                    f"process_batch_jit, pinned, beam_zone {cfg.beam_zone}")
    groups = pl.lane_groups(b, pl.LANE_GROUP)
    entries = [e for key, e in pl.compiled_entries().items()
               if key[-1] == dev and isinstance(e, pl._LaneGroups)]
    assert len(entries) == 1 and entries[0].groups == groups, entries
    torch.cuda.synchronize()
    reset_launch_counts()
    copies = dict(pl.LANE_GROUP_COPIES)
    for _ in range(reps):
        process_batch_jit(pinned, FilterConfig(), bench_dims,
                          layout="planar", device=dev)
    grouped = launch_counts()
    assert pl.LANE_GROUP_COPIES == {
        "calls": copies["calls"] + reps,
        "groups": copies["groups"] + reps * len(groups)}, (
        copies, pl.LANE_GROUP_COPIES)
    for k in SCAN_KERNELS:  # one per group (K11 one per 128 of its lanes)
        per = sum(-(-(hi - lo) // 128) if k == "gather_pack" else 1
                  for lo, hi in groups)
        assert grouped[k] == reps * per, (k, grouped[k], reps * per)
    print(f"  (f) process_batch_jit on the {b} planar scans from pinned "
          f"memory: {len(groups)} lane groups of {pl.LANE_GROUP}, bit-equal "
          f"to process_batch (default and beam_zone 45.5); {reps} replays: "
          f"LANE_GROUP_COPIES {pl.LANE_GROUP_COPIES}, launches {grouped}",
          flush=True)

    # (g) No synchronising call, eager or compiled.
    on = dict(device=dev)
    bat = dict(layout="planar", device=dev)
    calls = {
        "process_scan": lambda: process_scan(pts, FilterConfig(), dims,
                                             **on),
        "packed_scan": lambda: packed_scan(pts, FilterConfig(), dims, **on),
        "process_batch": lambda: process_batch(planar, FilterConfig(),
                                               bench_dims, **bat),
        "process_scan_jit": lambda: process_scan_jit(pts, FilterConfig(),
                                                     dims, **on),
        "packed_scan_jit": lambda: packed_scan_jit(pts, FilterConfig(), dims,
                                                   **on),
        "process_batch_jit": lambda: process_batch_jit(
            planar, FilterConfig(), bench_dims, **bat),
        "process_batch_jit, pinned": lambda: process_batch_jit(
            pinned, FilterConfig(), bench_dims, **bat),
        "packed_scan_jit, hot swap": lambda: packed_scan_jit(
            pts, FilterConfig(beam_zone=42.5), dims, **on)}
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    for what, fn in calls.items():
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"  (g) no synchronising call under set_sync_debug_mode('error'):"
          f" {', '.join(calls)}", flush=True)
    for key, e in pl.compiled_entries().items():
        if key[-1] == dev:
            st = e.stats
            print(f"    graph {key[0]} {key[4]} {key[3]}: nodes {st['nodes']}, "
                  f"capture {st['capture_ms']:.3f} ms, instantiate "
                  f"{st['instantiate_ms']:.3f} ms, pool "
                  f"{st['pool_bytes']} B", flush=True)
    return launches


# ---- phase 10: the compiled SP run (CUDA-graph replays) ----

SP_PAIRS = 10  # eager / compiled pairs of SP calls, in turns
SP_CALLS = 5  # SP calls of one scan per pass
HARNESS_PAIRS = 4  # eager / compiled pairs of SP harness runs, in turns
HARNESS_SCANS = 5  # OS1-128 drive scans per harness run
HARNESS_HZ = 10.0  # their rate (drop mode)


def sp_per_scan(local: int, star: bool) -> dict:
    """Launches of each kernel per SP scan on a rank of ``local`` wedges:
    K4 (where the star search is on) and K12 one a local wedge, K5 and K6
    two passes, K14 two, the ring geometry two (sp_tensorize and
    sort_by_azimuth), the others one."""
    return {"ingest_prep": 1, "discover_rings": 1, "assign_rings": 1,
            "star_walk": local if star else 0, "group_rank": 2,
            "group_place": 2, "ring_geometry": 2, "xz_zero": 1,
            "flood_blocked": 1, "flood_road": local, "marker_state": 2}


def device_busy(fn, n: int):
    """(device busy ms per call, busy share of the profiled wall, device
    ops per call) of fn, which makes n calls, under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not e.name.startswith("urf::"))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / n / 1e3, busy / 1e6 / window, len(spans) / n


def phase_sp_compiled(dev, configs, smi, device_parity_gate) -> dict:
    """make_azimuth_pipeline(8 wedges) on one card, its run a CUDA-graph
    replay: (a) phase 5's two deployments, star search on and off, each
    replay bit-equal to run.eager on every field (planar too, star on) and
    gated against the oracle; (b) each of the 15 dynamic fields swapped in
    turn and all at once: equal to run.eager under the new configuration,
    no capture, max_x=12 changing the labels; a static swap, one capture;
    (c) eager, compiled and a hot swap under
    torch.cuda.set_sync_debug_mode("error"); (d) the launch counters per
    replay; (e) each graph's nodes, capture and instantiation ms and pool
    bytes; (f) eager against compiled in turns on the OS1-128 scan: host
    enqueue and host-to-host p50, device busy and ops; (g) the harness in
    SP mode at 10 Hz on OS1-128 drive scans, compiled against eager in
    turns.  Returns (d)'s launch counts."""
    from urban_road_filter_torch import (
        FilterConfig, ScanResult, launch_counts, pad_scan, pad_scan_planar,
        reset_launch_counts)
    from urban_road_filter_torch import pipeline as pl
    from urban_road_filter_torch.io import make_drive
    from urban_road_filter_torch.io.replay import ReplayHarness
    from urban_road_filter_torch.parallel.azimuth_parallel import (
        azimuth_sorted, make_azimuth_pipeline)

    # (a) Replay against eager, and the oracle gate.
    deployments = sp_deployments()
    runs = {}
    for name, dims, scan, channels in deployments:
        pts = torch.from_numpy(pad_scan(scan, dims.max_points)).to(dev)
        for cname, cfg in configs.items():
            run = make_azimuth_pipeline(WEDGES, cfg, dims, device=dev)
            before = pl.CAPTURE_COUNTS["sp"]
            run(pts)  # the capture, after one eager run
            got = run(pts)
            assert pl.CAPTURE_COUNTS["sp"] == before + 1, (name, cname)
            same_fields(got, run.eager(pts), f"SP replay {name} {cname}")
            if cname == "default":
                planar = torch.from_numpy(pad_scan_planar(
                    scan, dims.max_points)).to(dev)
                same_fields(run(planar, layout="planar"),
                            run.eager(planar, layout="planar"),
                            f"SP replay {name} planar")
                assert pl.CAPTURE_COUNTS["sp"] == before + 2
            fetched = ScanResult(*(t.cpu() for t in got))
            assert bool(fetched.ok) and int(fetched.overflow) == 0
            labels, markers = fetched.labels.numpy(), fetched.markers.numpy()
            assert np.isfinite(markers).all() and int(labels.max()) <= 2
            agree, n_sys = device_parity_gate(scan, labels, markers, cfg,
                                              name, channels=channels)
            print(f"  (a) {name} {cname}: replay bit-equal to run.eager on "
                  f"every field; parity {agree:.6f}, systematic {n_sys}, "
                  f"rings {int(fetched.num_rings)}", flush=True)
            assert agree >= 0.999 and n_sys == 0, (name, cname, agree, n_sys)
            runs[name, cname] = (run, pts)

    # (b) Hot swaps, on each deployment's default run.
    for name, _, _, _ in deployments:
        run, pts = runs[name, "default"]
        base = run(pts)
        before = dict(pl.CAPTURE_COUNTS)
        for field, val in [*DYN_SWAPS.items(), ("all", None)]:
            cfg = (FilterConfig(**DYN_SWAPS) if field == "all"
                   else FilterConfig(**{field: val}))
            same_fields(run(pts, cfg), run.eager(pts, cfg),
                        f"SP {name} after the {field} swap")
        assert pl.CAPTURE_COUNTS == before, (before, pl.CAPTURE_COUNTS)
        assert not torch.equal(run(pts, FilterConfig(max_x=12.0)).labels,
                               base.labels), name
        same_fields(run(pts), base, f"SP {name} back to the default")
        run(pts, FilterConfig(blind_spots=False))
        assert pl.CAPTURE_COUNTS["sp"] == before["sp"] + 1, name
    print(f"  (b) {len(DYN_SWAPS)} dynamic fields swapped in turn and all at "
          f"once on both deployments: no capture, every replay equal to "
          f"run.eager under the new configuration; max_x=12 changes the "
          f"labels; a static swap (blind_spots=False) one capture each",
          flush=True)

    # (c) No synchronising call, eager or compiled.
    run, pts = runs["os1_128_262k", "default"]
    off, _ = runs["os1_128_262k", "star_off"]
    calls = {"eager": lambda: run.eager(pts),
             "compiled": lambda: run(pts),
             "compiled, hot swap": lambda: run(
                 pts, FilterConfig(beam_zone=42.5)),
             "eager, star off": lambda: off.eager(pts),
             "compiled, star off": lambda: off(pts)}
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    for fn in calls.values():
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"  (c) no synchronising call under set_sync_debug_mode('error'):"
          f" {', '.join(calls)}", flush=True)

    # (d) Launches credited per replay (the counters zeroed just before).
    reps = 5
    torch.cuda.synchronize()
    reset_launch_counts()
    for _ in range(reps):
        run(pts)
    launches = launch_counts()
    per_scan = sp_per_scan(WEDGES, True)
    for k, v in launches.items():
        assert v == reps * per_scan.get(k, 0), (k, v, reps)
    print(f"  (d) {reps} replays of the OS1-128 SP run: launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)

    # (e) The graphs.
    for (name, cname), (r, _) in runs.items():
        for key, e in r.entries.items():
            st = e.stats
            print(f"  (e) graph {name} {cname} {key[3]} {key[4]}"
                  f"{' blind_spots off' if not key[1].blind_spots else ''}"
                  f": nodes {st['nodes']}, capture {st['capture_ms']:.3f} "
                  f"ms, instantiate {st['instantiate_ms']:.3f} ms, pool "
                  f"{st['pool_bytes']} B", flush=True)

    # (f) Eager against compiled in turns, host to host, on the OS1-128
    # scan from pinned memory.
    _, sdims, scan, _ = deployments[0]
    host = torch.from_numpy(pad_scan(scan, sdims.max_points)).pin_memory()
    modes = {"eager": run.eager, "compiled": run}

    def one(fn):
        t0 = time.perf_counter()
        out = fn(host.to(dev, non_blocking=True))
        t1 = time.perf_counter()
        for t in out:
            t.cpu()
        return (t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3

    times = {m: [] for m in modes}
    for p in range(SP_PAIRS):
        for m in (("eager", "compiled") if p % 2 == 0
                  else ("compiled", "eager")):
            times[m] += [one(modes[m]) for _ in range(SP_CALLS)]
    busy = {}
    for m in ("eager", "compiled", "compiled", "eager"):
        busy[m] = device_busy(
            lambda: [one(modes[m]) for _ in range(SP_CALLS)], SP_CALLS)
    for m, tt in times.items():
        enq, wall = zip(*tt)
        b, share, ops = busy[m]
        print(f"  (f) OS1-128 SP {m}: host enqueue p50 "
              f"{statistics.median(enq):.4f} ms, host-to-host p50 "
              f"{statistics.median(wall):.4f} ms ({SP_PAIRS} pairs of "
              f"{SP_CALLS} calls in turns); device busy {b:.4f} ms a scan "
              f"({100 * share:.1f} % of the profiled wall), {ops:.1f} device "
              f"ops a scan; on {smi}", flush=True)

    # (g) The harness in SP mode at 10 Hz, compiled against eager in turns
    # (one SP run for all harness runs, so its capture comes before them).
    cfg = FilterConfig()
    scans = [azimuth_sorted(p) for p in make_drive(
        HARNESS_SCANS, sensor="os1_128", seed=31, firings=2048)]
    sp_run = make_azimuth_pipeline(WEDGES, cfg, sdims, device=dev)
    sp_run(torch.from_numpy(pad_scan_planar(scans[0], sdims.max_points))
           .to(dev), layout="planar")  # the harness's entry, captured

    def harness(m):
        got = []
        h = ReplayHarness(cfg=cfg, dims=sdims, azimuth_shard=WEDGES,
                          device=dev, rate_hz=HARNESS_HZ, on_scan=got.append)
        h._sp_run = sp_run if m == "compiled" else sp_run.eager
        s = h.run(iter(scans)).summary()
        assert s["errors"] == 0 and s["not_ok"] == 0, s
        return s, got

    topics = {m: harness(m)[1] for m in ("eager", "compiled")}  # warm-up
    same_outputs(topics["compiled"], topics["eager"], "SP harness")
    before = pl.CAPTURE_COUNTS["sp"]
    sums = {"eager": [], "compiled": []}
    for p in range(HARNESS_PAIRS):
        for m in (("eager", "compiled") if p % 2 == 0
                  else ("compiled", "eager")):
            sums[m].append(harness(m)[0])
    assert pl.CAPTURE_COUNTS["sp"] == before
    for m, ss in sums.items():
        lat = [s["latency_ms"] for s in ss]
        split = {k: statistics.median(s["breakdown_ms_p50"][k] for s in ss)
                 for k in ss[0]["breakdown_ms_p50"]}
        dropped = sum(s["dropped"] for s in ss)
        print(f"  (g) SP harness {m}, {HARNESS_PAIRS} runs of "
              f"{HARNESS_SCANS} OS1-128 scans at {HARNESS_HZ:g} Hz in "
              f"turns: latency p50 "
              f"{statistics.median(x['p50'] for x in lat):.3f} ms, p99 "
              f"{statistics.median(x['p99'] for x in lat):.3f} ms, "
              f"{dropped} dropped; dispatch / stage / fetch / post p50 "
              f"{split} ms; on {smi}", flush=True)
        assert dropped == 0, (m, dropped)
    print("  (g) the compiled harness's topics equal the eager harness's",
          flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False")
    from urban_road_filter_torch import FilterConfig, PipelineDims, _build
    from urban_road_filter_torch import pad_scan, planarize_batch
    from urban_road_filter_torch import unpack_planes
    from urban_road_filter_torch.utils.parity import device_parity_gate

    dev = torch.device("cuda", 0)
    dims = PipelineDims.for_sensor("os1-64")
    # bench.py's replay batch and its merged multi-LiDAR rig.
    bench_dims = PipelineDims(max_points=131072, rings=64, ring_capacity=2048,
                              beam_capacity=512)
    mdims = PipelineDims(max_points=262144, rings=128, ring_capacity=2048,
                         beam_capacity=1024)
    cfg = FilterConfig(star_shaped_method=False)

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"phase 1: built {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "Compiling entry" in line or "registers" in line:
            print("  " + line.strip())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    print("phase 2: kernels vs plain twins", flush=True)
    bench = [(f"bench_{'two_curbs' if i % 2 == 0 else 'blind_spot'}", s)
             for i, s in enumerate(bench_scans(BATCH))]
    merged = [(f"multi_lidar_{i}", s) for i, s in
              enumerate(multi_lidar_scans())]
    planar = torch.from_numpy(planarize_batch(np.stack(
        [pad_scan(p, bench_dims.max_points) for _, p in bench]))).to(dev)
    mrows = torch.from_numpy(np.stack(
        [pad_scan(p, mdims.max_points) for _, p in merged[:2]])).to(dev)
    kernels = phase_ingest(dev, cfg, planar, mrows)
    del mrows
    per_scan, unfused_launches = phase_kernels(dev, dims, cfg, os1_64_scan(),
                                               "OS1-64 drive scan")
    kernels.update(per_scan)
    kernels["gather_pack"]["b128"] = phase_gather_batch(dev, planar,
                                                        bench_dims)
    print("  the batched kernels (process_batch's lane axis)", flush=True)
    for k, entry in phase_batch_kernels(dev, bench, planar,
                                        bench_dims).items():
        kernels[k]["b128"] = entry
    del planar
    assert set(kernels) == set(_build.KERNELS), sorted(kernels)
    kernels["xz_zero"]["sp"] = phase_sp_stacked(dev, FilterConfig())
    # The per-scan kernels again at the shapes the batch path gives them
    # in phase 4: a bench lane and a merged multi-LiDAR scan (128 rings).
    lane, _ = phase_kernels(dev, bench_dims, cfg, bench[0][1], "bench lane",
                            timed={"ring_geometry"})
    kernels["ring_geometry"]["64x2048"] = lane["ring_geometry"]
    phase_kernels(dev, mdims, cfg, merged[0][1], "multi-LiDAR scan",
                  timed=False)

    configs = {"default": FilterConfig(), "star_off": cfg}
    print("phase 3: packed_scan on 9 full-size scans x 2 configurations",
          flush=True)
    scans = scans_for_pipeline()
    runs, scan_launches = phase_pipeline(dev, dims, configs, scans)
    print(f"  launches: {scan_launches}")
    assert_launched(scan_launches, SCAN_KERNELS, "the scan path")

    def gate_scans(runs, scans, configs):
        for cname, k, fetched, p50 in runs:
            name, pts = scans[k]
            packed, markers, ok, num_rings, overflow = (t.numpy()
                                                        for t in fetched)
            assert (packed.shape == (dims.max_points,)
                    and packed.dtype == np.uint8)
            assert markers.shape == (361, 6) and np.isfinite(markers).all()
            assert bool(ok) and int(num_rings) > 0
            labels, _, _ = unpack_planes(packed)
            assert int(labels.max()) <= 2
            agree, n_sys = device_parity_gate(pts, labels, markers,
                                              configs[cname], name)
            print(f"  {cname} {name}: p50 {p50:.3f} ms, parity {agree:.6f}, "
                  f"systematic {n_sys}, rings {int(num_rings)}, "
                  f"overflow {int(overflow)}", flush=True)
            assert agree >= 0.999 and n_sys == 0, (cname, name, agree, n_sys)

    gate_scans(runs, scans, configs)
    assert_no_jax()
    for cname in configs:
        lat = [p50 for c, _, _, p50 in runs if c == cname]
        print(f"  {cname}: scan latency p50 over scans "
              f"{statistics.median(lat):.3f} ms (host to host, incl. H2D + "
              f"D2H)")
    # The x/z-zero stencils off on the scenes whose star-hit curbs sit at
    # the 2-D azimuth 60.0, where a flood window starts: the gate passes
    # only where the port's azimuth is the oracle's (geometry.azimuth_2d).
    off = {"stencils_off": FilterConfig(x_zero_method=False,
                                        z_zero_method=False)}
    at_sixty = [s for s in scans
                if s[0] in ("two_curbs", "blind_spot", "curb_gap")]
    gate_scans(phase_pipeline(dev, dims, off, at_sixty)[0], at_sixty, off)

    print(f"phase 4: process_batch on {BATCH} planar scans of 131072 "
          f"points (default configuration)", flush=True)
    launches = phase_batch(dev, FilterConfig(), bench, merged, bench_dims,
                           mdims, smi, device_parity_gate)
    print(f"  launches: {launches}")
    assert_launched(launches, SCAN_KERNELS, "the batch path")
    # One launch of each kernel per batch run (K11 one per 128 lanes), not
    # one per lane.
    batch_runs = 1 + BATCH_REPS
    per_batch = {k: launches[k] / batch_runs for k in SCAN_KERNELS}
    print(f"  launches per batch of {BATCH}: {per_batch}", flush=True)
    assert per_batch == {**dict.fromkeys(SCAN_KERNELS, 1),
                         "gather_pack": -(-BATCH // 128)}, per_batch

    print(f"phase 5: the azimuth-sharded path, {WEDGES} wedges on the card",
          flush=True)
    sp_launches = phase_sp(dev, configs, smi, device_parity_gate)
    print(f"  launches: {sp_launches}")
    assert_no_jax()

    print("phase 6: the replay harness on the card", flush=True)
    replay_launches = phase_replay(dev, smi, device_parity_gate)
    print(f"  launches: {replay_launches}")
    assert_no_jax()
    # Every kernel ran on some path: K1-K11 on the scan and batch paths,
    # K12 and K14 on the SP path, K13 on the unfused one.
    runs_of = {k: launches.get(k, 0) for k in SCAN_KERNELS}
    runs_of["flood_road"] = sp_launches.get("flood_road", 0)
    runs_of["marker_state"] = sp_launches.get("marker_state", 0)
    runs_of["marker_first_nonroad"] = unfused_launches.get(
        "marker_first_nonroad", 0)
    assert_launched(runs_of, _build.KERNELS, "any path")

    print("phase 7: checked mode, data parallelism, the profiling hooks and "
          "the demo drive", flush=True)
    checked_launches = phase_checked(dev, dims, configs, scans, smi)
    print(f"  launches: {checked_launches}")
    assert_launched(checked_launches, SCAN_KERNELS, "the checked path")
    launches = phase_checked_replay(dev, smi)
    print(f"  launches: {launches}")
    assert_launched(launches, SCAN_KERNELS, "the checked harness")
    launches = phase_data_parallel(dev, FilterConfig(), bench, bench_dims)
    assert_launched(launches, SCAN_KERNELS, "the data-parallel path")
    launches = phase_traces()
    assert_launched(launches, SCAN_KERNELS, "the traced scan")
    launches = phase_demo(dev)
    print(f"  launches: {launches}")
    assert_launched(launches, SCAN_KERNELS, "the demo drive")
    assert_no_jax()

    print(f"phase 8: the SP path over the ranks of a process group, "
          f"{WEDGES} wedges", flush=True)
    t0 = time.perf_counter()
    phase_ranks(dev, configs, smi, device_parity_gate)
    print(f"  phase 8 took {time.perf_counter() - t0:.1f} s", flush=True)
    assert_no_jax()

    print("phase 9: the compiled entry points (CUDA-graph replays)",
          flush=True)
    t0 = time.perf_counter()
    launches = phase_compiled(dev, dims, bench_dims, configs, scans, bench,
                              smi, gate_scans)
    assert_launched(launches, SCAN_KERNELS, "the compiled entry points")
    print(f"  phase 9 took {time.perf_counter() - t0:.1f} s", flush=True)
    assert_no_jax()

    print(f"phase 10: the compiled SP run ({WEDGES} wedges on the card, "
          f"CUDA-graph replays)", flush=True)
    t0 = time.perf_counter()
    launches = phase_sp_compiled(dev, configs, smi, device_parity_gate)
    assert_launched(launches, SP_KERNELS, "the compiled SP run")
    print(f"  phase 10 took {time.perf_counter() - t0:.1f} s", flush=True)
    assert_no_jax()

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": tpu,
         "launches": runs_of[k], **kernels[k]}
        for k, (src, tpu) in _build.KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
