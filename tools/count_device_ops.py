#!/usr/bin/env python3
"""Device ops per call of K1 (ingest_prep) and K11 (gather_pack), counted
three ways on one CUDA card.

    python tools/count_device_ops.py [--windows 20] [--out F.json]

For K1 at B = 1 on the OS1-64 drive scan (rows), at the SP call's shape
and on the phase-4 batch (planes), and for K11 over the phase-4 batch (its
process_batch call, replayed):

- exactly, from a CUDA-graph capture of one call (``_build.device_ops``:
  the graph's kernel, memcpy and memset nodes);
- the wrapper's launch counter per call;
- torch.profiler's device events in each of ``--windows`` windows of 10
  calls (each ending in a synchronisation), and in an empty window opened
  right after each (events a window lost that turn up late would land
  there).

Prints the card's name and power limit and one JSON line.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
CALLS = 10


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=20)
    ap.add_argument("--out", default=None, help="write the result as JSON")
    args = ap.parse_args()
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("count_device_ops: needs a CUDA device")
    from urban_road_filter_torch import (
        FilterConfig, PipelineDims, _build, pad_scan, planarize_batch)
    from urban_road_filter_torch.ops import geometry, ingest

    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  ROOT / "chip_smoke.py")
    c = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(c)
    spec = importlib.util.spec_from_file_location(
        "profile_ring_kernels", ROOT / "tools/profile_ring_kernels.py")
    prk = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prk)

    dev = torch.device("cuda", 0)
    cfg = FilterConfig()
    smi = subprocess_card()
    print(smi, flush=True)
    n64 = PipelineDims.for_sensor("os1-64").max_points
    rows = torch.from_numpy(pad_scan(c.os1_64_scan(), n64)).to(dev)
    b1 = [v[None] for v in geometry.xyz_of(rows, "rows")[:3]]
    _, sp_dims, sp_scan, _ = c.sp_deployments()[0]
    sp, _, _ = c.sp_ring_inputs(dev, cfg,
                                pad_scan(sp_scan, sp_dims.max_points))
    planar = torch.from_numpy(planarize_batch(np.stack(
        [pad_scan(s, 131072) for s in c.bench_scans(c.BATCH)]))).to(dev)
    b128 = geometry.xyz_of(planar, "planar", batched=True)[:3]
    k11 = prk.batch_gather_calls(c, planar)["gather_pack"]
    cases = [("ingest_prep", "b1_rows", lambda: ingest.ingest_prep(*b1, cfg)),
             ("ingest_prep", "sp_rows", lambda: ingest.ingest_prep(*sp, cfg)),
             ("ingest_prep", "b128_planar",
              lambda: ingest.ingest_prep(*b128, cfg)),
             ("gather_pack", "b128_batch", k11)]

    def events(prof) -> int:
        return sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)

    out = {"card": smi}
    for kernel, what, fn in cases:
        exact = _build.device_ops(fn)
        torch.cuda.synchronize()
        before = _build.launch_counts()[kernel]
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        launches = (_build.launch_counts()[kernel] - before) / CALLS
        windows, drains = [], []
        for _ in range(args.windows):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(CALLS):
                    fn()
                torch.cuda.synchronize()
            windows.append(events(prof))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
            drains.append(events(prof))
        res = {"graph_ops_per_call": exact, "launches_per_call": launches,
               "calls_per_window": CALLS, "window_events": windows,
               "drain_events": drains}
        out[f"{kernel}/{what}"] = res
        print(kernel, what, json.dumps(res), flush=True)
    print(json.dumps(out))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


def subprocess_card() -> str:
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


if __name__ == "__main__":
    sys.exit(main())
