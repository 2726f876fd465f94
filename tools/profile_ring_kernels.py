#!/usr/bin/env python3
"""Device time per launch of ring discovery (K2) and ring assignment (K3),
and their wrappers' host time, on one CUDA card.

    python tools/profile_ring_kernels.py [TREE] [--out F.json]

TREE is a checkout of this repository (default: this one); its
urban_road_filter_torch is imported and its kernels built.  The inputs are
chip_smoke.py's: one OS1-64 drive scan at B = 1 (as process_scan calls
the kernels) and reordered ring-major, the SP call's shape (262144 points,
128 rings, valid0 & fits), two merged multi-LiDAR scans (262144 points,
128 rings) and the phase-4 batch (B = 128).  For each: the
device time of every kernel the wrapper launched, summed per call
(torch.profiler over 20 calls, after warm-up), and the wrapper's host time
per call (perf_counter over 50 calls).  Prints the card's name and power
limit and one JSON line.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CALLS = 20


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

    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  ROOT / "chip_smoke.py")
    c = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(c)
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
    n64 = PipelineDims.for_sensor("os1-64").max_points
    scan = c.os1_64_scan()
    for name, s in (("b1", scan), ("ring_major", c.ring_major(scan))):
        inputs[name] = (*rows_input(torch.from_numpy(pad_scan(s, n64))
                                    .to(dev)), 64)
    _, sp_dims, sp_scan, _ = c.sp_deployments()[0]
    _, alpha, valid = c.sp_ring_inputs(
        dev, cfg, pad_scan(sp_scan, sp_dims.max_points))
    inputs["sp"] = (alpha, valid, sp_dims.rings)
    merged = torch.from_numpy(np.stack([pad_scan(s, 262144) for s in
                                        c.multi_lidar_scans()[:2]])).to(dev)
    inputs["merged_b2"] = (*rows_input(merged), 128)
    planar = torch.from_numpy(planarize_batch(np.stack(
        [pad_scan(s, 131072) for s in c.bench_scans(c.BATCH)]))).to(dev)
    x, y, z, _ = geometry.xyz_of(planar, "planar", batched=True)
    valid = geometry.roi_mask_xyz(x, y, z, cfg)
    _, alpha = geometry.vertical_angles(x, y, z)
    inputs["b128"] = (alpha, valid, 64)

    def device_ms(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        per = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                us = getattr(e, "self_device_time_total", None)
                if us is None:
                    us = e.self_cuda_time_total
                per[e.key[:60]] = us / CALLS / 1e3
        return sum(per.values()), per

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / 50 * 1e3

    out = {"tree": args.tree}
    for name, (alpha, valid, rings) in inputs.items():
        k2 = lambda: ingest.discover_rings(alpha, valid, cfg.interval, rings)
        angles, _ = k2()
        k3 = lambda: ingest.assign_rings(alpha, valid, angles, cfg.interval)
        res = {}
        for kname, fn in (("discover_rings", k2), ("assign_rings", k3)):
            total, per = device_ms(fn)
            res[kname] = {"device_ms": total, "host_ms": host_ms(fn),
                          "kernels": per}
        out[name] = res
        print(name, json.dumps({k: (round(v["device_ms"], 5),
                                    round(v["host_ms"], 5))
                                for k, v in res.items()}), flush=True)
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
