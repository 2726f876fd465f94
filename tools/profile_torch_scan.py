#!/usr/bin/env python3
"""Where a scan's time goes in the PyTorch port, on one CUDA card.

    python tools/profile_torch_scan.py [--star-off] [--reps 3] [--batch B]
                                       [--sp D] [--out F.json]
    python tools/profile_torch_scan.py --graph [--pairs 10] [--star-off]
                                       [--batch B | --sp D] [--harness]
                                       [--out F]

Runs urban_road_filter_torch.packed_scan (OS1-64 dims; the default
configuration, or with ``--star-off`` the star search off) on the 7
synthetic scenes at 64 rings x 2048 azimuths and 2 emulated OS1-64
drive scans: first unprofiled (host-to-host wall per scan and the host
time to enqueue it, p50), then under torch.profiler.  With ``--batch B``
it runs process_batch instead, on bench.py's batch of B planar scans
(131072 points, 64 rings x 2048 slots, two_curbs and blind_spot
alternating), one call per pass, and reports per scan of the batch.
With ``--sp D`` it runs the azimuth-sharded path (make_azimuth_pipeline,
D wedges on the card) on the emulated OS1-128 drive scan at 262144 points,
128 rings x 2048 slots, azimuth-sorted (chip_smoke.py phase 5), its
stages op by op (``run.eager``).
Prints the card's name and power limit; per stage (the pipeline's
``urf::<stage>`` ranges; a batch's ingest range covers K1-K3 over the
whole batch) per scan the host ms, the device ms of its device ops, the
port's CUDA kernels included, its span on the device timeline (gaps
included) and each kernel's device ms and launches; the device-busy share
of the profiled wall time; the device ops per scan; the kernels by device
time; and, with the star search on, the star stage's device ms and device
ops per scan, profiled on its own (star_hits on each scan's K1 keys, or on
each wedge's with ``--sp``).

With ``--graph`` it times the eager entry point against its compiled
counterpart (packed_scan against packed_scan_jit; with ``--batch B``
process_batch against process_batch_jit; with ``--sp D`` the SP run's
``run.eager`` against ``run``, its CUDA-graph replay) in turns,
``--pairs`` pairs of passes over the scans (eager then compiled, then
the other way round), in one process: per mode the host enqueue p50 and
host-to-host wall p50 per scan, and, profiled one pass each in turns,
the device busy ms per scan, its share of the profiled wall and the
device ops per scan; per stage its device ms per scan, the eager
pass's from its urf::<stage> ranges and the compiled pass's from the
replay record (utils.profiling.replay_record: under the profiler the
entry replays its traced variant, whose stages time themselves with
event nodes), side by side; for the compiled entry its graph's kernel,
memcpy and memset nodes, capture and instantiation ms and pool bytes.
``--harness`` does the same for the replay harness at 10 Hz on 30
emulated OS1-64 drive scans (depth 1, drop mode), its default path
(packed_scan_jit) against the same harness with packed_scan: latency p50
and its dispatch / stage / fetch / post split; with ``--sp D`` on 10
OS1-128 drive scans (azimuth-sorted) in SP mode, one SP run (captured
before the first harness run) replayed against its ``run.eager``.
Without ``--graph`` every stage time is the eager path's (its
urf::<stage> ranges and their launches).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def star_calls(dev, cfg, args, hosts, call):
    """[star_hits call] of each call of a pass, on the card, as the
    pipeline calls it: once over the (B, N) views of a batch (B = 1 for a
    scan) with their K1 keys, or, with ``--sp``, on each wedge's streams as
    one run of the SP path hands them to its star search (its probe's
    "star")."""
    from urban_road_filter_torch.ops import geometry, ingest
    from urban_road_filter_torch.ops.star import star_hits

    if args.sp:
        probe = {}
        call(hosts[0].to(dev), probe=probe)
        xw, yw, zw, vw, fkw, rkw = probe["star"]
        return [lambda k=k: star_hits(xw[k], yw[k], zw[k], vw[k], cfg,
                                      (fkw[k], rkw[k]))
                for k in range(xw.shape[0])]
    out = []
    for host in hosts:
        pts = host.to(dev)
        if args.batch:
            x, y, z, _ = geometry.xyz_of(pts, "planar", batched=True)
        else:
            x, y, z, _ = geometry.xyz_of(pts, "rows")
            x, y, z = x[None], y[None], z[None]
        valid, fk, r_key, _ = ingest.ingest_prep(x, y, z, cfg)
        out.append(lambda x=x, y=y, z=z, v=valid, f=fk, r=r_key: star_hits(
            x, y, z, v, cfg, (f, r)))
    return out


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _device_window(run_pass, n):
    """(device busy ms per scan, busy share of the profiled wall, device
    ops per scan, {stage: device ms per scan} of the pass's urf::<stage>
    ranges: an eager pass's) of one pass of n scans under
    torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from urban_road_filter_torch.utils.profiling import stage_device_time

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_pass()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    ev = [e for e in events if e.device_type == DeviceType.CUDA
          and not e.name.startswith("urf::")]
    if not ev:
        return None, None, None, {}
    busy = _union_us((e.time_range.start, e.time_range.end) for e in ev)
    stages = {st: rec["device_us"] / n / 1e3
              for st, rec in stage_device_time(events).items()
              if st != "(outside)"}
    return busy / n / 1e3, busy / window_us, len(ev) / n, stages


def _replay_stages(before: dict, kind: str, per_call: int) -> dict:
    """{stage: device ms per scan} of the traced replays of ``kind`` since
    the replay record read ``before``, and "(replay)" for the whole
    replay."""
    from urban_road_filter_torch.utils import profiling

    profiling.flush()
    now = profiling.replay_record().get(kind)
    if now is None:
        return {}
    was = before.get(kind, {"timed": 0, "replay_ms": 0.0, "stage_ms": {}})
    scans = (now["timed"] - was["timed"]) * per_call
    if not scans:
        return {}
    out = {st: (ms - was["stage_ms"].get(st, 0.0)) / scans
           for st, ms in now["stage_ms"].items()}
    out["(replay)"] = (now["replay_ms"] - was["replay_ms"]) / scans
    return out


def graph_main(args) -> int:
    """--graph: the eager entry point against its compiled counterpart in
    turns (see the module docstring)."""
    from urban_road_filter_torch import (
        FilterConfig, PipelineDims, pad_scan, packed_scan, packed_scan_jit,
        planarize_batch, process_batch, process_batch_jit)
    from urban_road_filter_torch import pipeline as pl
    from urban_road_filter_torch.io import SCENES, make_drive, make_scan
    from urban_road_filter_torch.utils import profiling

    dev = torch.device("cuda", 0)
    cfg = FilterConfig(star_shaped_method=not args.star_off)
    smi = _smi()
    summary = {"card": smi, "star_shaped_method": cfg.star_shaped_method,
               "pairs": args.pairs, "modes": {}}
    if args.harness:
        return harness_graph(args, dev, cfg, smi, summary)
    entries = None  # the process's compiled entries, read after the runs
    if args.sp:
        from urban_road_filter_torch.parallel.azimuth_parallel import (
            make_azimuth_pipeline)

        kind = "sp"
        dims, hosts = sp_inputs()
        per_call = 1
        sp_run = make_azimuth_pipeline(args.sp, cfg, dims)
        entries = sp_run.entries
        calls = {"eager": sp_run.eager, "jit": sp_run}
    elif args.batch:
        kind = "batch"
        dims = PipelineDims(max_points=131072, rings=64, ring_capacity=2048,
                            beam_capacity=512)
        scans = [make_scan(SCENES["two_curbs" if i % 2 == 0
                                  else "blind_spot"](),
                           n_rings=64, n_azimuth=2048, seed=i)
                 for i in range(args.batch)]
        hosts = [torch.from_numpy(planarize_batch(np.stack(
            [pad_scan(s, dims.max_points) for s in scans]))).pin_memory()]
        per_call = args.batch
        calls = {"eager": lambda p: process_batch(p, cfg, dims,
                                                  layout="planar"),
                 "jit": lambda p: process_batch_jit(p, cfg, dims,
                                                    layout="planar")}
    else:
        kind = "packed"
        dims = PipelineDims.for_sensor("os1-64")
        scans = [make_scan(spec(), n_rings=64, n_azimuth=2048, seed=i)
                 for i, spec in enumerate(SCENES.values())]
        scans += list(make_drive(2, sensor="os1_64", seed=41))
        hosts = [torch.from_numpy(pad_scan(s, dims.max_points)).pin_memory()
                 for s in scans]
        per_call = 1
        calls = {"eager": lambda p: packed_scan(p, cfg, dims),
                 "jit": lambda p: packed_scan_jit(p, cfg, dims)}

    def run(fn, host):
        t0 = time.perf_counter()
        out = fn(host.to(dev, non_blocking=True))
        t1 = time.perf_counter()
        for t in out:
            t.cpu()
        return ((t1 - t0) * 1e3 / per_call,
                (time.perf_counter() - t0) * 1e3 / per_call)

    for fn in calls.values():  # warm-up; the compiled entry's capture
        for host in hosts:
            run(fn, host)
    times = {m: [] for m in calls}
    for p in range(args.pairs):
        for m in (("eager", "jit") if p % 2 == 0 else ("jit", "eager")):
            times[m] += [run(calls[m], host) for host in hosts]
    n = len(hosts) * per_call
    device = {}
    profiling.flush()
    record = profiling.replay_record()
    for m in ("eager", "jit", "jit", "eager"):  # in turns, the second kept
        device[m] = _device_window(
            lambda: [run(calls[m], host) for host in hosts], n)
    summary["stage_ms_per_scan"] = {
        "eager": device["eager"][3],
        "jit": _replay_stages(record, kind, per_call)}
    for m in calls:
        enq, wall = zip(*times[m])
        busy, share, ops, _ = device[m]
        summary["modes"][m] = {
            "enqueue_ms_p50": statistics.median(enq),
            "wall_ms_p50": statistics.median(wall),
            "device_busy_ms_per_scan": busy, "device_busy_share": share,
            "device_ops_per_scan": ops}
    summary["graphs"] = [
        {"key": f"{k[0]} {k[3]} {tuple(k[4])}", **e.stats}
        for k, e in (pl.compiled_entries() if entries is None
                     else entries).items()
        if k[0] == kind and k[-1] == dev]
    return _report(args, summary)


def sp_inputs():
    """(dims, [pinned host scan]) of the SP profile: the emulated OS1-128
    drive scan at 262144 points, 128 rings x 2048 slots, azimuth-sorted
    (chip_smoke.py phase 5)."""
    from urban_road_filter_torch import PipelineDims, pad_scan
    from urban_road_filter_torch.io import make_drive
    from urban_road_filter_torch.parallel.azimuth_parallel import (
        azimuth_sorted)

    dims = PipelineDims(max_points=262144, rings=128, ring_capacity=2048,
                        beam_capacity=1024)
    scan = azimuth_sorted(next(make_drive(1, sensor="os1_128", seed=31,
                                          firings=2048)))
    return dims, [torch.from_numpy(pad_scan(scan, dims.max_points))
                  .pin_memory()]


def harness_graph(args, dev, cfg, smi, summary) -> int:
    """--graph --harness: the replay harness at 10 Hz, compiled against
    eager, in turns."""
    from urban_road_filter_torch import PipelineDims, packed_scan
    from urban_road_filter_torch import pipeline as pl
    from urban_road_filter_torch.io import make_drive
    from urban_road_filter_torch.io import replay as R

    compiled = R.packed_scan_jit
    kind = "packed"
    entries = None  # the process's compiled entries, read after the runs
    if args.sp:
        from urban_road_filter_torch import pad_scan_planar
        from urban_road_filter_torch.parallel.azimuth_parallel import (
            azimuth_sorted, make_azimuth_pipeline)

        kind = "sp"
        dims = sp_inputs()[0]
        drive = [azimuth_sorted(p) for p in make_drive(
            10, sensor="os1_128", seed=31, firings=2048)]
        sp_run = make_azimuth_pipeline(args.sp, cfg, dims)
        sp_run(torch.from_numpy(pad_scan_planar(drive[0], dims.max_points))
               .to(dev), layout="planar")  # the harness's entry, captured
        entries = sp_run.entries
    else:
        dims = PipelineDims.for_sensor("os1-64")
        drive = list(make_drive(30, sensor="os1_64", seed=43))

    def harness(m):
        R.packed_scan_jit = compiled if m == "jit" else packed_scan
        try:
            h = R.ReplayHarness(cfg=cfg, dims=dims, device=dev, rate_hz=10.0,
                                azimuth_shard=args.sp)
            if args.sp:  # one SP run for every harness run
                h._sp_run = sp_run if m == "jit" else sp_run.eager
            s = h.run(iter(drive)).summary()
        finally:
            R.packed_scan_jit = compiled
        assert s["errors"] == 0 and s["not_ok"] == 0, s
        return s

    for m in ("eager", "jit"):  # warm-up (drops allowed); the capture
        harness(m)
    runs = {m: [] for m in ("eager", "jit")}
    for p in range(args.pairs):
        for m in (("eager", "jit") if p % 2 == 0 else ("jit", "eager")):
            runs[m].append(harness(m))
    device = {}
    for m in ("eager", "jit", "jit", "eager"):
        device[m] = _device_window(lambda: harness(m), len(drive))
    for m, ss in runs.items():
        busy, share, ops, _ = device[m]
        split = {k: statistics.median(s["breakdown_ms_p50"][k] for s in ss)
                 for k in ss[0]["breakdown_ms_p50"]}
        summary["modes"][m] = {
            "latency_ms_p50": statistics.median(
                s["latency_ms"]["p50"] for s in ss),
            "latency_ms_p99": statistics.median(
                s["latency_ms"]["p99"] for s in ss),
            "breakdown_ms_p50": split,
            "dropped": sum(s["dropped"] for s in ss),
            "device_busy_ms_per_scan": busy,
            "device_busy_share": share, "device_ops_per_scan": ops}
    summary["graphs"] = [
        {"key": f"{k[0]} {k[3]} {tuple(k[4])}", **e.stats}
        for k, e in (pl.compiled_entries() if entries is None
                     else entries).items()
        if k[0] == kind and k[-1] == dev]
    return _report(args, summary)


def _report(args, summary) -> int:
    print(summary["card"], f"star_shaped_method="
          f"{summary['star_shaped_method']}, {args.pairs} pairs in turns")
    for m, rec in summary["modes"].items():
        print(f"  {m:5s} " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in rec.items()))
    stages = summary.get("stage_ms_per_scan")
    if stages:
        print("  device ms per scan by stage (eager ranges | compiled, the "
              "traced replays' events):")
        for st in dict.fromkeys([*stages["eager"], *stages["jit"]]):
            e, j = stages["eager"].get(st), stages["jit"].get(st)
            print(f"    {st:16s} " + " | ".join(
                "not measured" if v is None else f"{v:.4f}" for v in (e, j)))
    for g in summary["graphs"]:
        print(f"  graph {g['key']}: nodes {g['nodes']}, capture "
              f"{g['capture_ms']:.3f} ms, instantiate "
              f"{g['instantiate_ms']:.3f} ms, pool {g['pool_bytes']} B")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3,
                    help="profiled passes over the 9 scans (or the batch)")
    ap.add_argument("--out", default=None, help="write the summary as JSON")
    ap.add_argument("--star-off", action="store_true",
                    help="FilterConfig(star_shaped_method=False)")
    ap.add_argument("--batch", type=int, default=0,
                    help="profile process_batch on B scans instead")
    ap.add_argument("--sp", type=int, default=0,
                    help="profile the SP path with D wedges instead")
    ap.add_argument("--graph", action="store_true",
                    help="eager against the compiled entry point, in turns")
    ap.add_argument("--pairs", type=int, default=10,
                    help="--graph: pairs of passes in turns")
    ap.add_argument("--harness", action="store_true",
                    help="--graph: the replay harness at 10 Hz (in SP mode "
                         "with --sp)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_scan: needs a CUDA device")
    if args.graph:
        return graph_main(args)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from urban_road_filter_torch import (
        FilterConfig, PipelineDims, pad_scan, packed_scan, planarize_batch,
        process_batch)
    from urban_road_filter_torch.io import SCENES, make_drive, make_scan
    from urban_road_filter_torch.utils.profiling import stage_device_time

    dev = torch.device("cuda", 0)
    cfg = FilterConfig(star_shaped_method=not args.star_off)
    if args.sp:
        from urban_road_filter_torch.parallel.azimuth_parallel import (
            make_azimuth_pipeline)

        dims, hosts = sp_inputs()
        scans_per_call = 1
        # The stages op by op: the urf::sp_* ranges exist only there.
        call = make_azimuth_pipeline(args.sp, cfg, dims).eager
    elif args.batch:
        dims = PipelineDims(max_points=131072, rings=64, ring_capacity=2048,
                            beam_capacity=512)
        scans = [make_scan(SCENES["two_curbs" if i % 2 == 0
                                  else "blind_spot"](),
                           n_rings=64, n_azimuth=2048, seed=i)
                 for i in range(args.batch)]
        hosts = [torch.from_numpy(planarize_batch(np.stack(
            [pad_scan(s, dims.max_points) for s in scans]))).pin_memory()]
        scans_per_call = args.batch
        call = lambda pts: process_batch(pts, cfg, dims, layout="planar")
    else:
        dims = PipelineDims.for_sensor("os1-64")
        scans = [make_scan(spec(), n_rings=64, n_azimuth=2048, seed=i)
                 for i, spec in enumerate(SCENES.values())]
        scans += list(make_drive(2, sensor="os1_64", seed=41))
        hosts = [torch.from_numpy(pad_scan(s, dims.max_points)).pin_memory()
                 for s in scans]
        scans_per_call = 1
        call = lambda pts: packed_scan(pts, cfg, dims)

    def run(host):
        """One call; returns the host ms per scan to enqueue it (the
        pipeline returns before the device is done) and to fetch its
        outputs."""
        t0 = time.perf_counter()
        out = call(host.to(dev, non_blocking=True))
        t1 = time.perf_counter()
        for t in out:
            t.cpu()
        return ((t1 - t0) * 1e3 / scans_per_call,
                (time.perf_counter() - t0) * 1e3 / scans_per_call)

    for host in hosts:  # warm-up
        run(host)
    runs = [run(host) for _ in range(args.reps) for host in hosts]
    enqueues, walls = zip(*runs)

    n = args.reps * len(hosts) * scans_per_call
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            for host in hosts:
                run(host)
        window_us = (time.perf_counter() - t0) * 1e6

    # Device rows are kernels, copies and memsets, plus the urf:: ranges
    # projected onto the device timeline (spans, gaps included).  A stage's
    # device ms: every device op inside its window, its kernels included
    # (utils.profiling.stage_device_time).
    dev_events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not e.name.startswith("urf::")]
    busy_us = _union_us((e.time_range.start, e.time_range.end)
                        for e in dev_events)
    stages = {}
    for stage, rec in stage_device_time(prof.events()).items():
        stages[stage] = {
            "device_ms": rec["device_us"] / n / 1e3,
            "device_ops": rec["ops"] / n,
            "unmatched_ranges": rec["unmatched"],
            "kernels": {k: {"device_ms": us / n / 1e3, "launches": c / n}
                        for k, (us, c) in rec["kernels"].items()}}
    kernels = []
    for e in prof.key_averages():
        self_dev_us = getattr(e, "self_device_time_total", None)
        if self_dev_us is None:
            self_dev_us = e.self_cuda_time_total
        if e.key.startswith("urf::k::"):
            continue
        if e.key.startswith("urf::"):
            st = stages.setdefault(e.key[5:], {})
            if e.device_type == DeviceType.CPU:
                st["host_ms"] = e.cpu_time_total / n / 1e3
            else:  # the range's own projection: its PyTorch ops, gaps in
                st["device_span_ms"] = self_dev_us / n / 1e3
        elif self_dev_us > 0 and e.device_type == DeviceType.CUDA:
            kernels.append((self_dev_us / n / 1e3, e.count / n, e.key))
    kernels.sort(reverse=True)
    attributed = sum(s.get("device_ms", 0.0) for s in stages.values())

    # The star stage on its own: star_hits as the pipeline calls it, on
    # each scan's (or wedge's, or lane's) K1 keys, profiled alone.
    star = None
    if cfg.star_shaped_method:
        calls = star_calls(dev, cfg, args, hosts, call)
        for fn in calls:  # warm-up
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as sprof:
            for _ in range(args.reps):
                for fn in calls:
                    fn()
            torch.cuda.synchronize()
        ev = [e for e in sprof.events() if e.device_type == DeviceType.CUDA]
        m = args.reps * len(hosts) * scans_per_call
        star = {"device_ms_per_scan": sum(e.time_range.end
                                          - e.time_range.start
                                          for e in ev) / m / 1e3,
                "device_ops_per_scan": len(ev) / m} if ev else None

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    summary = {
        "card": smi, "star_shaped_method": cfg.star_shaped_method,
        "batch": args.batch, "sp_wedges": args.sp,
        "scans": len(hosts) * scans_per_call,
        "reps": args.reps,
        "wall_ms_p50": statistics.median(walls),
        "enqueue_ms_p50": statistics.median(enqueues),
        "profiled_wall_ms_per_scan": window_us / n / 1e3,
        "device_busy_ms_per_scan": busy_us / n / 1e3 if dev_events else None,
        "device_busy_share": busy_us / window_us if dev_events else None,
        "device_ops_per_scan": len(dev_events) / n,
        "device_ms_in_stages_per_scan": attributed,
        "stages": stages,
        "star_stage": star,
        "kernels": [{"ms_per_scan": ms, "calls_per_scan": c, "name": k}
                    for ms, c, k in kernels[:30]],
    }
    print(smi, f"star_shaped_method={cfg.star_shaped_method}")
    print(f"host-to-host wall per scan, p50: {summary['wall_ms_p50']:.3f} ms "
          f"(unprofiled; host enqueue p50 {summary['enqueue_ms_p50']:.3f} "
          f"ms); profiled: {summary['profiled_wall_ms_per_scan']:.3f} ms")
    if dev_events:
        print(f"device busy {summary['device_busy_ms_per_scan']:.3f} ms per "
              f"scan, {100 * summary['device_busy_share']:.1f} % of the "
              f"profiled wall; {summary['device_ops_per_scan']:.0f} device "
              f"ops per scan")
    else:
        print("device time: not measured (the profiler saw no device ops)")
    if star:
        print(f"star stage alone: {star['device_ms_per_scan']:.4f} ms device "
              f"time, {star['device_ops_per_scan']:.1f} device ops per scan")
    elif cfg.star_shaped_method:
        print("star stage alone: not measured (the profiler saw no device "
              "ops)")
    lost = {k: s["unmatched_ranges"] for k, s in stages.items()
            if s.get("unmatched_ranges")}
    if lost:
        print(f"WARNING: the profiler lost events; ranges left without a "
              f"device projection per stage {lost}: those stages' device ms "
              f"below are too low")
    print(f"device ms inside the stages' ranges "
          f"{summary['device_ms_in_stages_per_scan']:.4f} per scan (the "
          f"rest: copies outside the pipeline)")
    for name, s in stages.items():
        print(f"  stage {name:12s} host {s.get('host_ms', 0):8.3f} ms  "
              f"device {s.get('device_ms', 0):8.4f} ms "
              f"({s.get('device_ops', 0):5.1f} ops)  "
              f"device span {s.get('device_span_ms', 0):8.3f} ms")
        for k, v in s.get("kernels", {}).items():
            print(f"      kernel {k:22s} device {v['device_ms']:8.4f} ms  "
                  f"x{v['launches']:.1f}")
    for k in summary["kernels"][:15]:
        print(f"  {k['ms_per_scan']:8.4f} ms  x{k['calls_per_scan']:6.1f}  "
              f"{k['name'][:90]}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
