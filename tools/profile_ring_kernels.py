#!/usr/bin/env python3
"""Device time per launch of every kernel wrapper of the port, its count
of device ops per call, and its host time, on one CUDA card.

    python tools/profile_ring_kernels.py [TREE] [--out F.json]

TREE is a checkout of this repository (default: this one); its
urban_road_filter_torch is imported and its kernels built.  The inputs are
chip_smoke.py's phase 2:

- ring discovery (K2) and ring assignment (K3) on one OS1-64 drive scan at
  B = 1 (as process_scan calls them) and reordered ring-major, at the SP
  call's shape (262144 points, 128 rings, valid0 & fits), on two merged
  multi-LiDAR scans (262144 points, 128 rings) and on the phase-4 batch
  (B = 128, also as rows of 4 floats, "b128_rows"); the ingest prep (K1)
  at B = 1, at the SP call's shape and at B = 128 (planes and rows);
- the gather + pack (K11) of the phase-4 batch (128 lanes of 64 x 2048),
  replayed from one process_batch run of the tree: 128 single-scan calls
  in trees before the batched gather, one call over the batch since (and
  there the same lanes as 128 single-scan calls, "gather_pack_lanes");
- the per-scan kernels K4-K14 (star search, rank, place, x/z-zero, flood
  fill, markers, gather + pack, road mask, marker keys, marker state) on
  the OS1-64 scan (64 rings x 4096 slots), a bench lane (64 x 2048) and a
  merged multi-LiDAR scan (128 x 2048), as phase 2 calls them, with the
  PyTorch calls phase 2 times beside K6 (index_put_) and K11 (the indexed
  gather);
- the blocked bits (K8) also with every slot a curb ("flood_blocked_all_
  curbs", its worst case);
- the road mask (K12) over the 8 wedges of the SP run of phase 5's OS1-128
  scan (128 rings x 384 slots each), 8 launches per call, as the SP path
  calls it, the star search over the same 8 wedges (32768 points each),
  the SP path's two K5 calls (262144 ids over 9 and over 1025 groups), and
  its K8 and K14 calls of one scan (8 and 16 per-wedge calls in trees
  before the wedge axis, 1 and 2 since), the last four replayed from the
  calls a run of the tree's SP path made;
- the SP path's sp_xz_zero stage of one scan (its halo exchange and
  stencils: halo rows in memory and two K7 launches in older trees, one
  K7 launch on the halo blocks since, "sp_xz_zero"), replayed from a run,
  and there K7's SP entry alone ("xz_zero_halo"); K7 is called in the
  form the tree's pipeline calls it (in place since it is one);
- beside K4 the whole star stage as the pipeline calls it ("star_stage":
  star_hits with the scan's K1 keys), and, in trees whose K4 walks sorted
  streams, the two stable sorts on their own ("beam_streams").

For each wrapper call: the device time of every device op it enqueued
(kernels, memsets, copies), summed per call, and their count per call
(torch.profiler over 20 calls, after warm-up), and the wrapper's host time
per call (perf_counter over 50 calls, no synchronisation inside).  Prints
the card's name and power limit and one JSON line.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CALLS = 20


def smoke_module():
    """This checkout's chip_smoke.py as a module (its helpers import the
    package lazily, so they use the tree on sys.path)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def scan_calls(dev, dims, cfg, scan) -> dict:
    """{kernel: wrapper call} of K4-K14 on one scan (a (M, >=3) host array)
    padded to dims, on the inputs chip_smoke.py's phase 2 gives them, plus
    "index_put" and "gather" (the PyTorch calls phase 2 times beside K6 and
    K11) and "star_stage", the whole star search as the pipeline calls it
    (star_hits on the rows-layout views with the scan's K1 keys).  K4 is
    called in the tree's form: from the unsorted keys (star_search), or, in
    trees from before it, on the streams of the two stable sorts, which are
    then timed on their own as "beam_streams".  K6 is called
    as the tree's ops.place takes it: with K5's group totals and a tuple
    of fields, or, in trees from before that argument, with x, y, z."""
    import torch

    from urban_road_filter_torch import pad_scan
    from urban_road_filter_torch.ops import blind_spots as bs
    from urban_road_filter_torch.ops import geometry, ingest
    from urban_road_filter_torch.ops import markers as mk
    from urban_road_filter_torch.ops import star
    from urban_road_filter_torch.ops.gather import gather_pack
    from urban_road_filter_torch.ops.marker_state import marker_state
    from urban_road_filter_torch.ops.place import group_place
    from urban_road_filter_torch.ops.rank import group_positions
    from urban_road_filter_torch.ops import stencil_kernels

    r, p, n = dims.rings, dims.ring_capacity, dims.max_points
    pts = torch.from_numpy(pad_scan(scan, n)).to(dev)
    x, y, z, _ = geometry.xyz_of(pts, "rows")
    x, y, z = x.contiguous(), y.contiguous(), z.contiguous()
    valid = geometry.roi_mask_xyz(x, y, z, cfg)
    _, alpha = geometry.vertical_angles(x, y, z)
    angles, num_rings = geometry.discover_rings(alpha, valid, cfg.interval,
                                                rings=r)
    ring_id = geometry.assign_rings(alpha, valid, angles, cfg.interval)
    # The star stage as the pipeline calls it: rows-layout views and this
    # scan's K1 keys.
    rx, ry, rz, _ = geometry.xyz_of(pts, "rows")
    _, fk1, rk1, _ = ingest.ingest_prep(rx[None], ry[None], rz[None], cfg)
    keys = (fk1[0], rk1[0])
    rvalid = geometry.roi_mask_xyz(rx, ry, rz, cfg)
    pos, counts = group_positions(ring_id, r + 1)
    layout, _, _ = geometry.tensorize(x, y, z, ring_id, p, rings=r)
    stenciled = layout._replace(
        label=stencil_kernels.fused_xz_zero(layout, cfg).label)
    if hasattr(stencil_kernels, "fused_xz_zero_"):  # K7 in place
        table = layout.label.clone()
        xz_zero = lambda: stencil_kernels.fused_xz_zero_(
            layout._replace(label=table), cfg)
    else:
        xz_zero = lambda: stencil_kernels.fused_xz_zero(layout, cfg)
    bz = cfg.beam_zone
    w = bs.window_widths(geometry.max_distance(layout), bz)
    blocked = bs.flood_blocked(stenciled, w, bz)
    curbs = stenciled._replace(label=torch.full_like(stenciled.label, 2))
    reach = bs.sweep_reach(stenciled, blocked, w, num_rings, cfg)
    flooded, kf = bs.flood_labeled(stenciled, *reach, w, bz, num_rings)
    road = stenciled._replace(label=flooded)
    srt = geometry.sort_by_azimuth(road)
    ok = torch.sum(valid) >= 30
    prr = int(cfg.probably_road_ring)
    if "counts" in inspect.signature(group_place).parameters:
        place = lambda: group_place(ring_id, pos, counts, (x, y, z), r, p)
    else:
        place = lambda: group_place(ring_id, pos, x, y, z, r, p)

    def index_put():
        buf = torch.zeros((r + 1, p + 1, 3), dtype=torch.float32, device=dev)
        return buf.index_put_((torch.clamp(ring_id, max=r).long(),
                               torch.clamp(pos, max=p).long()),
                              torch.stack([x, y, z], 1))

    def gather():
        return flooded[torch.clamp(ring_id, 0, r - 1).long(),
                       torch.clamp(pos, 0, p - 1).long()]

    star_calls = {"star_stage": lambda: star.star_hits(rx, ry, rz, rvalid,
                                                       cfg, keys)}
    if hasattr(star, "star_search"):  # K4 from the unsorted keys
        star_calls["star_walk"] = lambda: star.star_search(*keys, rz, cfg)
    else:  # the two stable sorts, then K4 on the sorted streams
        streams = star.beam_streams(rx, ry, rz, rvalid, cfg, keys)
        star_calls["beam_streams"] = lambda: star.beam_streams(
            rx, ry, rz, rvalid, cfg, keys)
        star_calls["star_walk"] = lambda: star.star_walk(*streams, cfg)
    return {
        **star_calls,
        "group_rank": lambda: group_positions(ring_id, r + 1),
        "group_place": place,
        "index_put": index_put,
        "xz_zero": xz_zero,
        "flood_blocked": lambda: bs.flood_blocked(stenciled, w, bz),
        "flood_blocked_all_curbs": lambda: bs.flood_blocked(curbs, w, bz),
        "flood_labeled": lambda: bs.flood_labeled(stenciled, *reach, w, bz,
                                                  num_rings),
        "marker_points": lambda: mk.marker_points(road, num_rings, kf),
        "gather_pack": lambda: gather_pack(flooded, ring_id, pos, valid, ok,
                                           prr),
        "gather": gather,
        "flood_road": lambda: bs.flood_road(stenciled, *reach, w, bz),
        "marker_first_nonroad": lambda: mk.marker_first_nonroad(road,
                                                                num_rings),
        "marker_state": lambda: marker_state(srt, num_rings),
    }


def batch_gather_calls(c, planar) -> dict:
    """{"gather_pack": the gather + pack (K11) of one process_batch run on
    the phase-4 batch (128 planar scans, 64 x 2048, default configuration),
    replayed as the tree's batch path makes it: one call per lane in trees
    before the batched gather, one call over the batch since; there also
    "gather_pack_lanes", the same lanes as 128 single-scan calls}."""
    from urban_road_filter_torch import (
        FilterConfig, PipelineDims, pipeline, process_batch)
    from urban_road_filter_torch.ops import gather

    dims = PipelineDims(max_points=131072, rings=64, ring_capacity=2048,
                        beam_capacity=512)
    name = ("gather_pack_batch" if hasattr(pipeline, "gather_pack_batch")
            else "gather_pack")
    fn = getattr(pipeline, name)
    recorded = c.recorded_calls(pipeline, name, lambda: process_batch(
        planar, FilterConfig(), dims, layout="planar"))
    calls = {"gather_pack": lambda: [fn(*a) for a in recorded]}
    if name == "gather_pack_batch":
        (tables, ids, pos, valid, ok, prr), = recorded
        calls["gather_pack_lanes"] = lambda: [
            gather.gather_pack(t, ids[b], q, valid[b], ok[b], prr)
            for b, (t, q) in enumerate(zip(tables, pos))]
    return calls


def sp_wedge_calls(dev, c, cfg) -> dict:
    """{"flood_road": K12 over the wedges of one SP run of phase 5's OS1-128
    scan (configuration ``cfg``), as the SP path calls it (one launch per
    wedge); "star_stage": the SP path's star_hits calls (one per wedge),
    "group_rank_G": its two K5 calls (G = 9 and 1025 groups),
    "flood_blocked" and "marker_state": its K8 and K14 calls of one scan
    (per wedge in older trees, over the wedge axis since), each as
    recorded from a run of the tree's SP path with the default
    configuration, so a tree is measured on the inputs its own partition
    makes, whatever its probe holds}."""
    import torch

    from urban_road_filter_torch import FilterConfig, pad_scan
    from urban_road_filter_torch.ops import blind_spots as bs
    from urban_road_filter_torch.parallel import azimuth_parallel as ap

    _, dims, scan, _ = c.sp_deployments()[0]
    host = torch.from_numpy(pad_scan(scan, dims.max_points)).to(dev)
    probe = {}
    ap.make_azimuth_pipeline(c.WEDGES, cfg, dims, device=dev)(host,
                                                              probe=probe)
    wedges = [ap._rows(probe["layout"], k, dims.rings)
              for k in range(c.WEDGES)]
    reach = (probe["reach_f"], probe["reach_b"])

    owner = {"star_hits": ap, "group_positions": ap, "marker_state": ap,
             "flood_blocked": bs, "_halo_stencils": ap}
    recorded = {name: [] for name in owner}

    def recording(name):
        fn = getattr(owner[name], name)

        def call(*args, **kwargs):
            recorded[name].append((args, kwargs))
            return fn(*args, **kwargs)
        return fn, call

    saved = {name: recording(name) for name in recorded}
    try:
        for name, (_, call) in saved.items():
            setattr(owner[name], name, call)
        run = ap.make_azimuth_pipeline(c.WEDGES, FilterConfig(), dims,
                                       device=dev)
        # The stages op by op (run.eager, where the tree compiles run), so
        # each call is recorded once.
        getattr(run, "eager", run)(host)
    finally:
        for name, (fn, _) in saved.items():
            setattr(owner[name], name, fn)
    fns = {name: fn for name, (fn, _) in saved.items()}

    def replay(name):
        return lambda: [fns[name](*a, **kw) for a, kw in recorded[name]]

    # The star stage last: in trees where it is ~300 device ops a call, the
    # profiler hands some of its events to the next profile, which then
    # reads short.
    calls = {f"group_rank_{a[1]}": (lambda a=a, kw=kw:
                                    fns["group_positions"](*a, **kw))
             for a, kw in recorded["group_positions"]}
    calls["flood_road"] = lambda: [bs.flood_road(lay, *reach, probe["w"],
                                                 cfg.beam_zone)
                                   for lay in wedges]
    # K8 and K14 as the tree's SP path calls them: per wedge (8 and 16
    # calls per scan) or over the wedge axis (1 and 2).
    calls["flood_blocked"] = replay("flood_blocked")
    calls["marker_state"] = replay("marker_state")
    # The sp_xz_zero stage (halo exchange and stencils; in place since K7
    # took the halo rows, an idempotent rewrite of the recorded table), and
    # K7's SP entry alone where the tree has one.
    calls["sp_xz_zero"] = replay("_halo_stencils")
    if "halo" in probe:
        from urban_road_filter_torch.ops.stencil_kernels import (
            fused_xz_zero_halo)

        lay, left, right, prefix, total = probe["halo"]
        calls["xz_zero_halo"] = lambda: fused_xz_zero_halo(
            lay, left, right, prefix, total, cfg)
    calls["star_stage"] = replay("star_hits")
    return calls


def scan_shapes(c):
    """(name, dims, host scan) of phase 2's three per-scan shapes."""
    from urban_road_filter_torch import PipelineDims

    return [("os1_64", PipelineDims.for_sensor("os1-64"), c.os1_64_scan()),
            ("bench_lane", PipelineDims(max_points=131072, rings=64,
                                        ring_capacity=2048,
                                        beam_capacity=512),
             c.bench_scans(1)[0]),
            ("multi_lidar", PipelineDims(max_points=262144, rings=128,
                                         ring_capacity=2048,
                                         beam_capacity=1024),
             c.multi_lidar_scans()[0])]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", nargs="?", default=str(ROOT))
    ap.add_argument("--out", default=None, help="write the result as JSON")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("profile_ring_kernels: needs a CUDA device")
    from urban_road_filter_torch import (
        FilterConfig, PipelineDims, _build, pad_scan, planarize_batch)
    from urban_road_filter_torch.ops import geometry, ingest

    c = smoke_module()
    _build.library()
    dev = torch.device("cuda", 0)
    cfg = FilterConfig(star_shaped_method=False)

    def rows_input(rows):
        x, y, z, _ = geometry.xyz_of(rows, "rows", batched=rows.ndim == 3)
        valid = geometry.roi_mask_xyz(x, y, z, cfg)
        _, alpha = geometry.vertical_angles(x, y, z)
        if alpha.ndim == 1:
            alpha, valid = alpha[None], valid[None]
        return alpha.contiguous(), valid.contiguous()

    inputs = {}
    prep = {}  # K1's (x, y, z) views
    n64 = PipelineDims.for_sensor("os1-64").max_points
    scan = c.os1_64_scan()
    for name, s in (("b1", scan), ("ring_major", c.ring_major(scan))):
        rows = torch.from_numpy(pad_scan(s, n64)).to(dev)
        inputs[name] = (*rows_input(rows), 64)
        if name == "b1":
            prep[name] = [v[None] for v in geometry.xyz_of(rows, "rows")[:3]]
    _, sp_dims, sp_scan, _ = c.sp_deployments()[0]
    prep["sp"], alpha, valid = c.sp_ring_inputs(
        dev, cfg, pad_scan(sp_scan, sp_dims.max_points))
    inputs["sp"] = (alpha, valid, sp_dims.rings)
    merged = torch.from_numpy(np.stack([pad_scan(s, 262144) for s in
                                        c.multi_lidar_scans()[:2]])).to(dev)
    inputs["merged_b2"] = (*rows_input(merged), 128)
    batch = np.stack([pad_scan(s, 131072) for s in c.bench_scans(c.BATCH)])
    planar = torch.from_numpy(planarize_batch(batch)).to(dev)
    x, y, z, _ = geometry.xyz_of(planar, "planar", batched=True)
    prep["b128"] = (x, y, z)
    valid = geometry.roi_mask_xyz(x, y, z, cfg)
    _, alpha = geometry.vertical_angles(x, y, z)
    inputs["b128"] = (alpha, valid, 64)
    batch_rows = torch.from_numpy(batch).to(dev)
    prep["b128_rows"] = geometry.xyz_of(batch_rows, "rows", batched=True)[:3]
    inputs["b128_rows"] = (*rows_input(batch_rows), 64)

    def device_ms(fn):
        """(device ms per call, device ops per call, {op: ms per call});
        None for the ms where the profiler saw no device op (every call
        here launches one, so its events were lost: not measured)."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        per, ops = {}, 0
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                us = getattr(e, "self_device_time_total", None)
                if us is None:
                    us = e.self_cuda_time_total
                per[e.key[:60]] = us / CALLS / 1e3
                ops += e.count
        return sum(per.values()) if ops else None, ops / CALLS, per

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / 50 * 1e3

    def profiled(calls):
        res = {}
        for kname, fn in calls.items():
            total, ops, per = device_ms(fn)
            res[kname] = {"device_ms": total, "device_ops": ops,
                          "host_ms": host_ms(fn), "kernels": per}
        print(json.dumps({k: (v["device_ms"] and round(v["device_ms"], 5),
                              v["device_ops"], round(v["host_ms"], 5))
                          for k, v in res.items()}), flush=True)
        return res

    out = {"tree": args.tree}
    print("batch (128 lanes, 64 x 2048)", end=" ")
    out["batch"] = profiled(batch_gather_calls(c, planar))
    for name, (alpha, valid, rings) in inputs.items():
        k2 = lambda: ingest.discover_rings(alpha, valid, cfg.interval, rings)
        angles, _ = k2()
        k3 = lambda: ingest.assign_rings(alpha, valid, angles, cfg.interval)
        calls = {"discover_rings": k2, "assign_rings": k3}
        if name in prep:
            calls["ingest_prep"] = lambda: ingest.ingest_prep(*prep[name],
                                                              cfg)
        print(name, end=" ")
        out[name] = profiled(calls)
    del planar, merged, batch_rows
    out["per_scan"] = {}
    for name, dims, host in scan_shapes(c):
        print(f"{name} ({dims.rings} x {dims.ring_capacity})", end=" ")
        out["per_scan"][name] = profiled(scan_calls(dev, dims, cfg, host))
    print(f"sp_wedges ({c.WEDGES} x 128 x 384)", end=" ")
    out["sp_wedges"] = profiled(sp_wedge_calls(dev, c, cfg))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    out["card"] = smi
    print(smi)
    print(json.dumps(out))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
