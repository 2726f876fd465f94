#!/usr/bin/env python3
"""Trees against each other on one CUDA card: the ingest kernels K1-K3,
the star search (K4), rank and placement (K5, K6), the flood fill (K8,
K9, K12), the marker table (K10) and state (K14), and the end-to-end
metrics of the PyTorch port.

    python tools/ab_ingest_torch.py TREE [TREE ...] [--e2e-only]
                                    [--graph] [--out F.json]

Each TREE is a checkout of this repository (the working tree ".", or a
commit unpacked with ``git archive`` into the gitignored ``chip_tree/``).
List them in turns (parent, change, change, parent), so that drift of the
shared host shows.  Each tree runs in its own process, which imports
urban_road_filter_torch from that tree and builds its kernels there, and
measures:

- CUDA-event times (median of 50 wrapper calls after 5 warm-up, as
  chip_smoke.py times them) of K1 ingest_prep, K2 discover_rings and K3
  assign_rings as the pipelines call them: at B = 1 on the OS1-64 drive
  scan (131072 points, 64 rings), at the SP call's shape (the OS1-128
  262144-point scan, 128 rings, valid0 & fits), on the ring-major OS1-64
  scan (K2's worst case) and at B = 128 (chip_smoke.py's phase-4 batch);
- CUDA-event times, the same way, of the whole star stage (star_hits
  with the scan's K1 keys), K4 star_walk and, in trees whose K4 walks
  sorted streams, the two stable sorts before it (beam_streams), K5
  group_rank, K6 group_place, the index_put_ call chip_smoke.py times
  beside it, K8 flood_blocked (also with every slot a curb), K9
  flood_labeled, K10 marker_points, K12 flood_road and K14 marker_state, at
  phase 2's three per-scan shapes: the OS1-64 scan (64 rings x 4096
  slots), a bench lane (64 x 2048) and a merged multi-LiDAR scan (128 x
  2048) (inputs from tools/profile_ring_kernels.py's scan_calls, which
  calls each tree's K4 and K6 in the form that tree takes);
- scan latency p50 (packed_scan on the 9 scans of phase 3, default and
  star off), scans/s at batch 128 (phase 4's timing) and SP latency p50
  (8 wedges on the OS1-128 scan, default and star off; the stages op by
  op, ``run.eager`` in trees that compile the SP run), host to host;
  with ``--e2e-only`` only these;
- with ``--graph``, in trees that have the compiled entry points, the
  scan latency p50 and the batch's scans/s again through packed_scan_jit
  and process_batch_jit, each pass in turns with its eager counterpart
  (``*_jit`` keys beside the eager ones, measured in the same turns).

The scans and the timing helpers come from this checkout's chip_smoke.py.
Prints the card's name and power limit and one JSON line per tree.  Needs
a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _module(name: str, path: str):
    """A file of this checkout as a module (chip_smoke.py's and
    profile_ring_kernels.py's helpers import the package lazily, so they
    use the tree on sys.path)."""
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(tree: str, e2e_only: bool = False, graph: bool = False) -> dict:
    root = Path(tree).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import urban_road_filter_torch as urf

    assert Path(urf.__file__).resolve().is_relative_to(root), urf.__file__
    from urban_road_filter_torch import (
        FilterConfig, PipelineDims, _build, pad_scan, planarize_batch)

    c = _module("chip_smoke_helpers", "chip_smoke.py")
    _build.library()
    dev = torch.device("cuda", 0)
    cfg = FilterConfig(star_shaped_method=False)
    out = {"tree": tree}
    _, sp_dims, sp_scan, _ = c.sp_deployments()[0]
    sp_host = pad_scan(sp_scan, sp_dims.max_points)
    bench_dims = PipelineDims(max_points=131072, rings=64,
                              ring_capacity=2048, beam_capacity=512)
    batch = planarize_batch(np.stack([pad_scan(s, bench_dims.max_points)
                                      for s in c.bench_scans(c.BATCH)]))
    if not e2e_only:
        out.update(kernel_times(c, dev, cfg, sp_dims, sp_host, batch))
    if graph and hasattr(urf, "packed_scan_jit"):
        e2e_graph(out, c, dev, bench_dims, batch)
    else:
        e2e(out, c, dev, cfg, sp_dims, sp_host, bench_dims, batch)
    return out


def e2e_graph(out, c, dev, bench_dims, batch) -> None:
    """The scan latency p50 (9 scans, default and star off) and scans/s
    at batch 128, eager and compiled in turns, into out."""
    import torch

    from urban_road_filter_torch import (
        FilterConfig, PipelineDims, ScanResult, pad_scan, packed_scan,
        packed_scan_jit, process_batch, process_batch_jit)

    dims = PipelineDims.for_sensor("os1-64")
    hosts = [torch.from_numpy(pad_scan(p, dims.max_points)).pin_memory()
             for _, p in c.scans_for_pipeline()]
    modes = {"": (packed_scan, process_batch),
             "_jit": (packed_scan_jit, process_batch_jit)}
    for cname, cfg in (("default", FilterConfig()),
                       ("star_off", FilterConfig(star_shaped_method=False))):
        p50 = {m: [] for m in modes}
        for k, host in enumerate(hosts):
            times = {m: [] for m in modes}
            for rep in range(1 + c.SCAN_REPS):
                for m in (modes if rep % 2 == 0 else reversed(list(modes))):
                    t0 = time.perf_counter()
                    [t.cpu() for t in modes[m][0](host.to(
                        dev, non_blocking=True), cfg, dims)]
                    times[m].append(time.perf_counter() - t0)
            for m in modes:
                p50[m].append(statistics.median(times[m][1:]) * 1e3)
        for m in modes:
            out.setdefault(f"scan_latency_p50_ms{m}", {})[cname] = (
                statistics.median(p50[m]))
    host = torch.from_numpy(batch).pin_memory()
    times = {m: [] for m in modes}
    for rep in range(1 + c.BATCH_REPS):
        for m in (modes if rep % 2 == 0 else reversed(list(modes))):
            t0 = time.perf_counter()
            res = modes[m][1](host.to(dev, non_blocking=True),
                              FilterConfig(), bench_dims, layout="planar")
            ScanResult(*(t.cpu() for t in res))
            times[m].append(time.perf_counter() - t0)
    for m in modes:
        out[f"scans_per_s_b128{m}"] = c.BATCH / statistics.median(
            times[m][1:])


def kernel_times(c, dev, cfg, sp_dims, sp_host, batch) -> dict:
    """The kernel rows of the docstring, CUDA-event times."""
    import torch

    from urban_road_filter_torch import PipelineDims, pad_scan
    from urban_road_filter_torch.ops import geometry, ingest

    def kernels(x, y, z, rings, alpha=None, valid=None):
        valid0 = ingest.ingest_prep(x, y, z, cfg)[0]
        if alpha is None:
            _, alpha = geometry.vertical_angles(x, y, z)
            valid = valid0
        angles, _ = ingest.discover_rings(alpha, valid, cfg.interval, rings)
        return {
            "ingest_prep": c.cuda_ms(lambda: ingest.ingest_prep(x, y, z,
                                                                cfg)),
            "discover_rings": c.cuda_ms(lambda: ingest.discover_rings(
                alpha, valid, cfg.interval, rings)),
            "assign_rings": c.cuda_ms(lambda: ingest.assign_rings(
                alpha, valid, angles, cfg.interval))}

    out = {}
    n64 = PipelineDims.for_sensor("os1-64").max_points
    for what, scan in (("b1", c.os1_64_scan()),
                       ("ring_major", c.ring_major(c.os1_64_scan()))):
        pts = torch.from_numpy(pad_scan(scan, n64)).to(dev)
        x, y, z, _ = geometry.xyz_of(pts, "rows")
        out[what] = kernels(x[None], y[None], z[None], 64)
    xyz, alpha, ring_valid = c.sp_ring_inputs(dev, cfg, sp_host)
    out["sp"] = kernels(*xyz, sp_dims.rings, alpha, ring_valid)

    planar = torch.from_numpy(batch).to(dev)
    out["b128"] = kernels(*geometry.xyz_of(planar, "planar",
                                           batched=True)[:3], 64)
    del planar

    prof = _module("profile_ring_kernels", "tools/profile_ring_kernels.py")
    for what, dims, scan in prof.scan_shapes(c):
        calls = prof.scan_calls(dev, dims, cfg, scan)
        out[what] = {k: c.cuda_ms(calls[k]) for k in
                     ("star_stage", "star_walk", "beam_streams",
                      "group_rank", "group_place", "index_put",
                      "flood_blocked", "flood_blocked_all_curbs",
                      "flood_labeled", "marker_points", "flood_road",
                      "marker_state")
                     if k in calls}
    return out


def e2e(out, c, dev, cfg, sp_dims, sp_host, bench_dims, batch) -> None:
    """The end-to-end rows of the docstring, into out."""
    import torch

    from urban_road_filter_torch import (
        FilterConfig, PipelineDims, ScanResult, process_batch)
    from urban_road_filter_torch.parallel.azimuth_parallel import (
        make_azimuth_pipeline)

    configs = {"default": FilterConfig(), "star_off": cfg}
    runs, _ = c.phase_pipeline(dev, PipelineDims.for_sensor("os1-64"),
                               configs, c.scans_for_pipeline())
    out["scan_latency_p50_ms"] = {
        k: statistics.median(p50 for cn, _, _, p50 in runs if cn == k)
        for k in configs}

    host = torch.from_numpy(batch).pin_memory()
    times = []
    for _ in range(1 + c.BATCH_REPS):
        t0 = time.perf_counter()
        res = process_batch(host.to(dev, non_blocking=True), FilterConfig(),
                            bench_dims, layout="planar")
        ScanResult(*(t.cpu() for t in res))
        times.append(time.perf_counter() - t0)
    out["scans_per_s_b128"] = c.BATCH / statistics.median(times[1:])

    host = torch.from_numpy(sp_host).pin_memory()
    out["sp_latency_p50_ms"] = {}
    for cname, conf in configs.items():
        run = make_azimuth_pipeline(c.WEDGES, conf, sp_dims, device=dev)
        run = getattr(run, "eager", run)  # op by op in every tree
        times = []
        for _ in range(1 + c.SCAN_REPS):
            t0 = time.perf_counter()
            ScanResult(*(t.cpu() for t in run(host.to(dev,
                                                      non_blocking=True))))
            times.append(time.perf_counter() - t0)
        out["sp_latency_p50_ms"][cname] = (statistics.median(times[1:])
                                           * 1e3)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", help="checkouts, in turns")
    ap.add_argument("--out", default=None, help="write all results as JSON")
    ap.add_argument("--e2e-only", action="store_true",
                    help="only the end-to-end metrics")
    ap.add_argument("--graph", action="store_true",
                    help="with --e2e-only: eager and compiled in turns")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("ab_ingest_torch: needs a CUDA device")
    if args.one:
        print(json.dumps(measure(args.trees[0], args.e2e_only, args.graph)),
              flush=True)
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    results = []
    for tree in args.trees:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", tree,
                              *(["--e2e-only"] if args.e2e_only else []),
                              *(["--graph"] if args.graph else [])],
                             capture_output=True,
                             text=True, timeout=1200)
        if res.returncode != 0:
            sys.stderr.write(res.stdout + res.stderr)
            return res.returncode
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results.append(json.loads(line))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "runs": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
