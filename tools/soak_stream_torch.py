#!/usr/bin/env python3
"""Streaming soak of the PyTorch port's replay harness on one CUDA card.

    python tools/soak_stream_torch.py --out soak.json [--seconds 30]

The reference is a live ROS node: one scan at a time, a queue of one, scans
dropped when processing lags the sensor (lidar_segmentation.cpp:53).
``urban_road_filter_torch.io.replay.ReplayHarness`` keeps those semantics;
this tool drives it on the card at the full OS1-64 size
(``PipelineDims.for_sensor("os1-64")``: 131072 points, 64 rings x 4096
slots) on emulated OS1-64 drive scans (``make_drive``, a pool of 16 scans
made up front and cycled, so scan generation stays off the clock), with
postprocess and marker strips on the host, and writes one JSON file:

  "device_floor":   depth-2 packed_scan steps flat out on scans already on
                    the card, each step ending in one fetch of ``ok``: the
                    device + synchronisation cost per scan that the harness
                    phases' latency is compared with.
  "10hz":           ``--seconds`` at the sensor rate, drop mode, depth 1.
  "overload_30hz":  30 Hz, drop mode (the JAX soak's overload rate; a
                    card that keeps up drops nothing).
  "overload_2x":    twice the flat-out scans/s, drop mode: the period is
                    below the per-scan time, so drops must engage.
  "flatout":        rate 0, depth 1, ``--seconds`` long.
  "depth":          flat out at depth 1 and depth 2 in turns (1, 2, 2, 1),
                    ``--seconds`` / 2 each, and "10hz_depth2".
  "resume":         a child process runs the harness with a checkpoint and
                    is killed (SIGKILL) mid-stream; a fresh harness resumes
                    from the checkpoint and must finish the stream with no
                    scan lost: its first scan is the checkpoint's position
                    and its last position is the stream's length.

Each harness phase carries the metrics summary (latency p50/p95/p99 and
the dispatch / stage / fetch / post breakdown, utils.metrics), unrounded
p50 and p99 from the per-scan latencies, and the card's name and power
limit.  Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

POOL = 16  # distinct drive scans, cycled


def scan_pool(n: int = POOL):
    from urban_road_filter_torch.io import make_drive

    return list(make_drive(n, sensor="os1_64", seed=41))


def cycle_source(pool, n):
    return itertools.islice(itertools.cycle(pool), n)


def phase(metrics, wall_s: float, **extra) -> dict:
    lat = np.asarray(metrics.latencies_ms or [float("nan")])
    return {**metrics.summary(), "wall_s_total": wall_s,
            "latency_ms_p50_unrounded": float(np.percentile(lat, 50)),
            "latency_ms_p99_unrounded": float(np.percentile(lat, 99)),
            **extra}


def run_harness(pool, n, **kw):
    from urban_road_filter_torch import PipelineDims
    from urban_road_filter_torch.io.replay import ReplayHarness

    h = ReplayHarness(dims=PipelineDims.for_sensor("os1-64"), **kw)
    t0 = time.perf_counter()
    m = h.run(cycle_source(pool, n))
    return h, m, time.perf_counter() - t0


def device_floor(pool, n: int = 60) -> dict:
    """p50/p99 of depth-2 packed_scan steps on scans already on the card,
    each step fetching one scan's ``ok``."""
    import torch

    from urban_road_filter_torch import (
        FilterConfig, PipelineDims, pad_scan_planar, packed_scan)

    cfg, dims = FilterConfig(), PipelineDims.for_sensor("os1-64")
    dev = [torch.from_numpy(pad_scan_planar(p, dims.max_points)).cuda()
           for p in pool[:4]]
    run = lambda k: packed_scan(dev[k % len(dev)], cfg, dims,
                                layout="planar")
    bool(run(0)[2])  # warm-up
    inflight = [run(0)]
    steps = []
    for i in range(n):
        t0 = time.perf_counter()
        inflight.append(run(i + 1))
        bool(inflight.pop(0)[2].cpu())
        steps.append((time.perf_counter() - t0) * 1e3)
    bool(inflight.pop(0)[2].cpu())
    return {"step_ms_p50": float(np.percentile(steps, 50)),
            "step_ms_p99": float(np.percentile(steps, 99)), "n": n}


def resume_child(ckpt: str, total: int) -> None:
    """The child of the resume phase: replays ``total`` pool scans flat out
    with a checkpoint until it is killed."""
    pool = scan_pool(4)
    run_harness(pool, total, checkpoint_path=ckpt)


def resume_check(total: int = 400) -> dict:
    """Kill a harness mid-stream (SIGKILL, no clean-up), then resume from
    its checkpoint with a fresh harness on the child's stream."""
    ckpt = os.path.join(tempfile.mkdtemp(prefix="urf_soak_"), "ckpt.json")
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--resume-child", ckpt,
         "--total", str(total)], cwd=ROOT)
    try:
        deadline = time.time() + 300
        seq = 0
        while time.time() < deadline and child.poll() is None:
            try:
                with open(ckpt) as f:
                    seq = json.load(f)["seq"]
            except (OSError, ValueError):
                seq = 0
            if seq >= total // 4:
                break
            time.sleep(0.05)
        assert child.poll() is None, "the child ended before it was killed"
        assert seq >= total // 4, f"the child reached seq {seq} only"
    finally:
        if child.poll() is None:
            child.send_signal(signal.SIGKILL)
        child.wait()
    with open(ckpt) as f:
        at_kill = json.load(f)["seq"]
    seen = []
    h, m, wall = run_harness(scan_pool(4), total, checkpoint_path=ckpt,
                             on_scan=lambda o: seen.append(o.seq))
    s = m.summary()
    assert seen and seen[0] == at_kill, (seen[:3], at_kill)
    assert h._seq == total and s["errors"] == 0, (h._seq, s)
    assert seen == list(range(at_kill, total)), "a scan was lost or repeated"
    return {"total": total, "checkpoint_seq_at_kill": at_kill,
            "resumed_scans": s["scans"], "final_seq": h._seq,
            "errors": s["errors"], "wall_s": wall}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=False, help="write the JSON here")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--resume-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--total", type=int, default=400, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.resume_child:
        resume_child(args.resume_child, args.total)
        return 0
    if not args.out:
        ap.error("--out is required")
    if os.path.basename(args.out).startswith("STREAM_r0"):
        ap.error("STREAM_r0*.json are the JAX package's records")

    import torch

    if not torch.cuda.is_available():
        sys.exit("soak_stream_torch: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    pool = scan_pool()
    sec = args.seconds
    out = {"card": smi, "device": torch.cuda.get_device_name(0),
           "points_per_scan": 131072, "dims": "os1-64", "pool": POOL,
           "scan_returns": [int(len(p)) for p in pool[:2]]}

    def save():
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)

    run_harness(pool, 4)  # builds the kernels, warms every shape
    out["device_floor"] = device_floor(pool)
    print("device_floor", out["device_floor"], flush=True)

    _, m, wall = run_harness(pool, int(10 * sec), rate_hz=10.0)
    out["10hz"] = phase(m, wall)
    _, m, wall = run_harness(pool, int(30 * min(sec, 10.0)), rate_hz=30.0)
    out["overload_30hz"] = phase(m, wall)
    _, m, wall = run_harness(pool, 100)  # sizes the flat-out phases
    n_flat = max(int(sec * m.summary()["scans_per_sec"]), 100)
    _, m, wall = run_harness(pool, n_flat)
    out["flatout"] = phase(m, wall)
    rate2 = 2.0 * out["flatout"]["scans_per_sec"]
    _, m, wall = run_harness(pool, int(rate2 * min(sec, 10.0)),
                             rate_hz=rate2)
    out["overload_2x"] = phase(m, wall, rate_hz=rate2)
    assert out["overload_2x"]["dropped"] > 0, "overload must drop scans"
    save()
    print({k: (v.get("scans"), v.get("dropped"), v.get("scans_per_sec"),
               v.get("latency_ms", {}).get("p50"))
           for k, v in out.items() if isinstance(v, dict)}, flush=True)

    turns = []
    for depth in (1, 2, 2, 1):
        _, m, wall = run_harness(pool, n_flat // 2, pipeline_depth=depth)
        turns.append(phase(m, wall, pipeline_depth=depth))
        print(f"depth {depth}: {m.summary()['scans_per_sec']} scans/s, "
              f"p50 {m.summary()['latency_ms']['p50']} ms", flush=True)
    out["depth"] = turns
    _, m, wall = run_harness(pool, int(10 * sec), rate_hz=10.0,
                             pipeline_depth=2)
    out["10hz_depth2"] = phase(m, wall)
    save()

    out["resume"] = resume_check()
    print("resume", out["resume"], flush=True)
    for k in ("10hz", "overload_30hz", "flatout", "overload_2x",
              "10hz_depth2"):
        assert out[k]["errors"] == 0 and out[k]["not_ok"] == 0, (k, out[k])
    save()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
