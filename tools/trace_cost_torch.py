#!/usr/bin/env python3
"""What the port's tracing costs on the device: each benchmark cell's
compiled entry, its traced variant (the same body with timing-event nodes
at its stage boundaries, utils.profiling) against its plain graph, in
turns.

    python tools/trace_cost_torch.py [--replays 200] [--turns 2]
                                     [--seed N] [--out F.json]

For each cell of BENCHMARK.json, through the benchmark's own call of the
cell: one call (the entry's plain graph captured) and one more while a
CPU-only profiler records (its traced variant captured); then the two
graphs replay ``--replays`` times back to back on the entry's buffers,
in turns plain, traced, traced, plain, ``--turns`` times, each batch of
replays timed with CUDA events around it.  Prints the card's name and
power limit, per cell the device ms per replay of each graph (every
batch, and the medians), the traced over the plain median, and both
graphs' kernel, memcpy and memset nodes, the traced variant's device ms
by stage and first to last event with no profiler recording (its replays
one at a time, each read once complete), and the entry's host ms a scan:
``--replays`` untraced calls, the enqueue time the benchmark takes, then
as many traced calls under a CPU-only profiler, the entry's ranges
(urf::entry.<kind> and its self time, copy_in, launch, clone,
stage_read); ``--out`` writes the same as JSON.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _per_replay_ms(graph, n: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def cell_cost(name: str, seed: int, replays: int, turns: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from benchmark import devtrace, harness, program_trace
    from urban_road_filter_torch import _build, pipeline
    from urban_road_filter_torch.utils import profiling

    cell = harness.Cell(name)
    run = harness.Run(cell, seed, "cuda")
    drv = harness.driver_class(cell.traffic["driver"])(run)
    def call(i):
        host, enqueue = drv.call(i)
        drv.release((i, host))
        return enqueue

    before = set(pipeline.compiled_entries().values())
    call(0)
    entries = (drv.sp.entries if hasattr(drv, "sp")
               else pipeline.compiled_entries())
    (entry,) = set(entries.values()) - before
    with profile(activities=[ProfilerActivity.CPU]):
        call(1)
    torch.cuda.synchronize()
    graphs = {"plain": entry.graph, "traced": entry.traced[0]}
    ms = {"plain": [], "traced": []}
    for _ in range(turns):
        for m in ("plain", "traced", "traced", "plain"):
            ms[m].append(_per_replay_ms(graphs[m], replays))
    med = {m: statistics.median(v) for m, v in ms.items()}
    # The traced variant's own stage times with no profiler recording:
    # replays one at a time, each read once it has completed.
    record = profiling.ReplayRecord()
    events = entry.traced[2]
    for _ in range(replays):
        graphs["traced"].replay()
        record.replayed(events)
        record.flush()
    (rec,) = record.totals().values()
    # The entry's host phases per scan: untraced, its enqueue time as the
    # benchmark takes it; traced with only the CPU profiler recording (no
    # device tracing to stretch the launch), its ranges.
    per_call = drv.scans_per_call
    enqueue = [call(i) for i in range(replays)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(replays):
            call(i)
    host = [(e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
            for e in prof.profiler.kineto_results.events()]
    ctx = SimpleNamespace(trace=devtrace.Trace([], host, 1.0,
                                               replays * per_call),
                          scans_per_call=per_call)
    split = {"enqueue_untraced": statistics.mean(enqueue) / per_call * 1e3,
             "entry": program_trace.span_ms(ctx, f"urf::entry.{entry.kind}"),
             "entry_self": program_trace.entry_self_ms(ctx)}
    for child in program_trace.CHILDREN:
        split[child[5:]] = program_trace.span_ms(ctx, child)
    return {"cell": name, "replays": replays, "ms_per_replay": ms,
            "median_ms": med, "traced_over_plain": med["traced"]
            / med["plain"],
            "nodes": {m: _build.graph_nodes(g) for m, g in graphs.items()},
            "unprofiled_stage_ms": {
                st: v / rec["timed"] for st, v in rec["stage_ms"].items()},
            "unprofiled_replay_ms": rec["replay_ms"] / rec["timed"],
            "host_ms_per_scan": split}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--replays", type=int, default=200)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--seed", type=int, default=2147483911)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("trace_cost_torch: needs a CUDA device")
    from benchmark import harness
    from urban_road_filter_torch import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.library()
    out = {"card": smi, "cells": []}
    for w in harness.benchmark_file()["workloads"]:
        rec = cell_cost(w["name"], args.seed, args.replays, args.turns)
        out["cells"].append(rec)
        print(f"{rec['cell']}: plain {rec['median_ms']['plain']:.5f} ms, "
              f"traced {rec['median_ms']['traced']:.5f} ms a replay "
              f"(x{rec['traced_over_plain']:.4f}); batches "
              f"{json.dumps(rec['ms_per_replay'])}; nodes "
              f"{json.dumps(rec['nodes'])}; unprofiled, the traced "
              f"variant's replay {rec['unprofiled_replay_ms']:.5f} ms, by "
              f"stage {json.dumps(rec['unprofiled_stage_ms'])}; host ms a "
              f"scan {json.dumps(rec['host_ms_per_scan'])}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
