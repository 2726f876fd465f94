#!/usr/bin/env python3
"""Smoke run of the PyTorch port (urban_road_filter_torch) on one CUDA card.

    python3 chip_smoke.py

1. Builds the port's CUDA kernels from urban_road_filter_torch/csrc with
   nvcc (sm_90a) and prints the build time and the card's name and power
   limit.
2. Holds each kernel (K4 star walk, K5 rank, K6 place, K7 x/z-zero, K8 +
   K9 flood fill, K10 markers, K11 gather+pack; the list is
   _build.KERNELS) against its plain PyTorch twin on the card, at OS1-64
   shapes (131072 points, 64 rings x 4096 slots) on one emulated OS1-64
   scan: every output must be bit-equal.  Prints median CUDA-event times
   of kernel and twin.
3. Drives the single-scan pipeline (packed_scan) on 9 full-size scans, the
   7 synthetic scenes at 64 rings x 2048 azimuths and 2 emulated OS1-64
   drive scans, in two configurations: the default (star search on) and
   star search off.  Launch counters are zeroed just before and read just
   after: every kernel must have run.  Each result is gated against the
   numpy oracle (agreement >= 0.999, 0 systematic flips).
4. Prints one JSON line of per-kernel results and, last,
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
import types

import numpy as np
import torch

REPS = 50  # timed launches per kernel / twin (after 5 warm-up launches)
WALK_REPS = 5  # timed launches of the star walk's twin (one op per step)
SCAN_REPS = 5  # timed pipeline runs per scan (after 1 warm-up run)


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


def max_abs_err(got, want) -> float:
    """Max |got - want| over paired outputs; raises unless bit-equal."""
    err = 0.0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype)
        assert g.device.type == "cuda"
        if g.numel():
            err = max(err, float((g.double() - w.double()).abs().max()))
        assert torch.equal(g, w), "kernel and plain twin disagree"
    return err


def phase_kernels(dev, dims, cfg):
    """Each kernel against its plain twin on one OS1-64 scan."""
    from urban_road_filter_torch import pad_scan
    from urban_road_filter_torch.io import make_drive
    from urban_road_filter_torch.ops import blind_spots as bs
    from urban_road_filter_torch.ops import geometry
    from urban_road_filter_torch.ops import markers as mk
    from urban_road_filter_torch.ops import star
    from urban_road_filter_torch.ops.gather import (
        gather_pack, gather_pack_plain)
    from urban_road_filter_torch.ops.place import (
        group_place, group_place_plain)
    from urban_road_filter_torch.ops.rank import (
        group_positions, group_positions_plain)
    from urban_road_filter_torch.ops.stencil_kernels import fused_xz_zero
    from urban_road_filter_torch.ops.xzero import x_zero
    from urban_road_filter_torch.ops.zzero import z_zero

    r, p, n = dims.rings, dims.ring_capacity, dims.max_points
    scan = next(make_drive(1, sensor="os1_64", seed=41))
    pts = torch.from_numpy(pad_scan(scan, n)).to(dev)
    x, y, z, _ = geometry.xyz_of(pts, "rows")
    x, y, z = x.contiguous(), y.contiguous(), z.contiguous()
    valid = geometry.roi_mask_xyz(x, y, z, cfg)
    _, alpha = geometry.vertical_angles(x, y, z)
    angles, num_rings = geometry.discover_rings(alpha, valid, cfg.interval,
                                                rings=r)
    ring_id = geometry.assign_rings(alpha, valid, angles, cfg.interval)
    out = {}

    def record(name, got, want, kernel, plain, plain_reps=REPS):
        out[name] = {"max_abs_err": max_abs_err(got, want),
                     "ms": cuda_ms(kernel),
                     "plain_ms": cuda_ms(plain, plain_reps)}
        print(f"  {name}: bit-equal, kernel {out[name]['ms']:.4f} ms, "
              f"plain {out[name]['plain_ms']:.4f} ms", flush=True)

    # K4: the star walk over the beam-sorted streams; also with the beams
    # merged 60 to one, so that segments outgrow the kernel's staging chunk.
    streams = star.beam_streams(x, y, z, valid, cfg)
    fk = streams[0]
    merged = (torch.where(fk < 360, fk // 60, fk), *streams[1:])
    max_abs_err((star.star_walk(*merged, cfg),),
                (star.star_walk_plain(*merged, cfg),))
    k4 = lambda: star.star_walk(*streams, cfg)
    p4 = lambda: star.star_walk_plain(*streams, cfg)
    hits = k4()
    assert int((hits > 0).sum()) > 30, "the scan must trigger star hits"
    record("star_walk", (hits,), (p4(),), k4, p4, WALK_REPS)

    # K5: stable rank within ring, 65 groups.
    k5 = lambda: group_positions(ring_id, r + 1)
    p5 = lambda: group_positions_plain(ring_id, r + 1)
    pos, counts = k5()
    record("group_rank", (pos, counts), p5(), k5, p5)

    # K6: placement into (64, 4096); also at capacity 64, where points
    # overflow and must be dropped and counted alike.
    k6 = lambda: group_place(ring_id, pos, x, y, z, r, p)
    p6 = lambda: group_place_plain(ring_id, pos, x, y, z, r, p)
    small = group_place(ring_id, pos, x, y, z, r, 64)
    max_abs_err(small, group_place_plain(ring_id, pos, x, y, z, r, 64))
    assert int(small[3]) > 0, "the capacity-64 case must overflow"
    record("group_place", k6(), p6(), k6, p6)

    # K7: both stencils on the placed layout, at window sizes 3, 10 and 5.
    layout, _ = geometry.tensorize(x, y, z, ring_id, p, rings=r)
    for cp in (3, 10):
        c = cfg.replace(curb_points=cp)
        max_abs_err((fused_xz_zero(layout, c).label,),
                    (z_zero(x_zero(layout, c), c).label,))
    k7 = lambda: fused_xz_zero(layout, cfg).label
    p7 = lambda: z_zero(x_zero(layout, cfg), cfg).label
    marked = k7()
    assert int((marked == 2).sum()) > 0, "the scan must trigger curb marks"
    record("xz_zero", (marked,), (p7(),), k7, p7)

    # K8: the flood fill's blocked bits on the stenciled layout.
    stenciled = layout._replace(label=marked)
    bz = cfg.beam_zone
    w = bs.window_widths(geometry.max_distance(layout), bz)
    k8 = lambda: bs.flood_blocked(stenciled, w, bz)
    p8 = lambda: bs.flood_blocked_plain(stenciled, w, bz)
    blocked = k8()
    assert bool(blocked[0].any()), "the curbs must block some windows"
    record("flood_blocked", blocked, p8(), k8, p8)

    # K9: the road mask and the markers' first-pass keys.
    reach = bs.sweep_reach(stenciled, blocked, w, num_rings, cfg)
    k9 = lambda: bs.flood_labeled(stenciled, *reach, w, bz, num_rings)
    p9 = lambda: bs.flood_labeled_plain(stenciled, *reach, w, bz, num_rings)
    flooded, kf = k9()
    assert int((flooded == 1).sum()) > 0, "the flood must reach road"
    record("flood_labeled", (flooded, kf), p9(), k9, p9)

    # K10: the marker table on the flooded, unsorted layout.
    road = stenciled._replace(label=flooded)
    k10 = lambda: mk.marker_points(road, num_rings, kf)
    p10 = lambda: mk.marker_points_plain(road, num_rings, kf)
    markers = k10()
    assert float(markers[:, 0].sum()) > 0, "the scan must yield markers"
    record("marker_points", (markers,), (p10(),), k10, p10)

    # K11: gather + gate + pack on the final label table; then indices
    # outside the table, negative ones included, must read label 0.
    table = flooded
    ok = torch.sum(valid) >= 30
    prr = int(cfg.probably_road_ring)
    k11 = lambda: gather_pack(table, ring_id, pos, valid, ok, prr)
    p11 = lambda: gather_pack_plain(table, ring_id, pos, valid, ok, prr)
    rng = np.random.default_rng(5)
    bad_ids = torch.from_numpy(
        rng.integers(-5, r + 5, n).astype(np.int32)).to(dev)
    bad_pos = torch.from_numpy(
        rng.integers(-5, p + 5, n).astype(np.int32)).to(dev)
    max_abs_err(gather_pack(table, bad_ids, bad_pos, valid, ok, prr),
                gather_pack_plain(table, bad_ids, bad_pos, valid, ok, prr))
    record("gather_pack", k11(), p11(), k11, p11)
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


def oracle_gate():
    """The reference package's numpy oracle gate, utils.parity's
    device_parity_gate.  It imports compact_markers from the JAX package's
    ops.markers inside the function, and that module imports jax; so the
    port's copy of compact_markers stands in for that module here, and
    nothing of JAX is loaded."""
    from urban_road_filter_tpu.utils.parity import device_parity_gate
    from urban_road_filter_torch.ops.markers import compact_markers

    shim = types.ModuleType("urban_road_filter_tpu.ops.markers")
    shim.compact_markers = compact_markers
    sys.modules.setdefault(shim.__name__, shim)
    return device_parity_gate


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False")
    from urban_road_filter_torch import FilterConfig, PipelineDims, _build
    from urban_road_filter_torch import unpack_planes
    device_parity_gate = oracle_gate()

    dev = torch.device("cuda", 0)
    dims = PipelineDims.for_sensor("os1-64")
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

    print("phase 2: kernels vs plain twins (os1-64 shapes)", flush=True)
    kernels = phase_kernels(dev, dims, cfg)
    assert set(kernels) == set(_build.KERNELS), sorted(kernels)

    configs = {"default": FilterConfig(), "star_off": cfg}
    print("phase 3: packed_scan on 9 full-size scans x 2 configurations",
          flush=True)
    scans = scans_for_pipeline()
    runs, launches = phase_pipeline(dev, dims, configs, scans)
    print(f"  launches: {launches}")
    missing = [k for k in _build.KERNELS if launches.get(k, 0) <= 0]
    assert not missing, f"kernels not launched by the main path: {missing}"
    for cname, k, fetched, p50 in runs:
        name, pts = scans[k]
        packed, markers, ok, num_rings, overflow = (t.numpy()
                                                    for t in fetched)
        assert packed.shape == (dims.max_points,) and packed.dtype == np.uint8
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
    assert "jax" not in sys.modules, "the port must run without JAX"
    for cname in configs:
        lat = [p50 for c, _, _, p50 in runs if c == cname]
        print(f"  {cname}: scan latency p50 over scans "
              f"{statistics.median(lat):.3f} ms (host to host, incl. H2D + "
              f"D2H)")

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[k], **kernels[k]}
        for k, (src, tpu) in _build.KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
