#!/usr/bin/env python3
"""Where the blocked bits (K8), the SP marker state (K14) and the marker
keys (K13) spend their time, phase by phase, on one CUDA card.

    python tools/clock_flood_markers.py [--out F.json]

Writes copies of urban_road_filter_torch/csrc/flood.cu and markers.cu with
%globaltimer reads (the card's nanosecond clock) at the phase boundaries
of blocked_kernel, marker_state_kernel and first_nonroad_kernel into the
gitignored build
directory, compiles them with the port's nvcc flags into a library of
their own and runs the port's wrappers on it, on the inputs of
tools/profile_ring_kernels.py: K8 and K14 on the OS1-64 drive scan (64
rings x 4096 slots), K8 also with every slot a curb, and both as one scan
of the SP path calls them (8 wedges of the OS1-128 scan, 128 x 384 slots;
K14's last launch is its second pass).  Every result is held bit-equal to
the unclocked kernel's.

Per input, in ns, from the blocks of the last launch: the span (first
block start to last block end) and, for the slowest block of each phase,
K8's loads (start to the row staged in shared memory: its count, then
its counted slots), its curb pass, the barrier, the scans (a thread's
starts, its warp, the warps' totals) and the compares with their stores;
K14's phase 1 (loads, the per-bin minima), the write of its f partials,
the spread of arrivals at the first grid barrier and its release, phase 2
(merging f from the partials, the max of d, forgetting, the two key
passes, the partials' writes), the second barrier and phase 3; K13's
ticket warp (its ticket, when the first block published kf, when the
other blocks' polls saw it), its slot threads' loads and fold (the
shared minima), the barrier and the issue of the global atomics (K13 on
the OS1-64 scan).  Beside
them the CUDA-event time of the clocked and the unclocked launch (median
of 20), so the clocks' own cost shows.  The clocks are patched in by
text (tools/_clock.py): the tool fails loudly when a source no longer has
the lines it anchors on.  Needs a CUDA device.
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
sys.path.insert(0, str(ROOT / "tools"))

import _clock  # noqa: E402

ROWS = 2048  # blocks recorded


# (anchor, replacement) per source: each anchor must occur.
FLOOD = (
    ("namespace {\n\nconstexpr int kStarts = 362;",
     _clock.declare("g_clk_blocked", ROWS)
     + "namespace {\n\nconstexpr int kStarts = 362;"),
    ("  const int k = row % A.rings;  // the ring within its wedge\n",
     "  const int k = row % A.rings;  // the ring within its wedge\n"
     "  const unsigned long long t_start = gtime();\n"),
    ("  cp_async_wait_all();\n  __syncthreads();\n  // The special starts",
     "  cp_async_wait_all();\n  __syncthreads();\n"
     "  const unsigned long long t_loaded = gtime();\n  // The special "
     "starts"),
    ("  if (sp_b) s_special[1] = 1;\n  __syncthreads();\n",
     "  if (sp_b) s_special[1] = 1;\n"
     "  const unsigned long long t_curbs = gtime();\n  __syncthreads();\n"
     "  const unsigned long long t_sync1 = gtime();\n"),
    ("  bool* out_f = A.blocked_f + (size_t)row * kStarts;",
     "  const unsigned long long t_scan = gtime();\n"
     "  bool* out_f = A.blocked_f + (size_t)row * kStarts;"),
    ("    out_b[i] = i == i_b ? spb : hb;\n  }\n}\n",
     "    out_b[i] = i == i_b ? spb : hb;\n  }\n  if (tid == 0) {\n"
     + _clock.record("g_clk_blocked", ROWS,
                     ("t_start", "t_loaded", "t_curbs", "t_sync1", "t_scan",
                      "gtime()", "gridDim.x"))
     + "  }\n}\n"),
)
MARKERS = (
    ("namespace {\n\nconstexpr int kBins = 361;",
     _clock.declare("g_clk_state", ROWS)
     + "namespace {\n\nconstexpr int kBins = 361;"),
    ("  unsigned int cand = 0u;\n",
     "  unsigned int cand = 0u;\n"
     "  unsigned long long* wclk = g_clk_state + blockIdx.x * 16 + 9;\n"
     "  if (threadIdx.x == 0 && blockIdx.x < %d) wclk[0] = gtime();\n"
     % ROWS),
    ("  __syncthreads();\n  for (int b = threadIdx.x; b < kBins; "
     "b += blockDim.x)\n    if (s_d[b] != s_prev[b]) {",
     "  __syncthreads();\n"
     "  if (threadIdx.x == 0 && blockIdx.x < %d) wclk[1] = gtime();\n"
     "  for (int b = threadIdx.x; b < kBins; b += blockDim.x)\n"
     "    if (s_d[b] != s_prev[b]) {" % ROWS),
    ("  __syncthreads();\n  unsigned int top = 0u;",
     "  __syncthreads();\n"
     "  if (threadIdx.x == 0 && blockIdx.x < %d) wclk[3] = gtime();\n"
     "  unsigned int top = 0u;" % ROWS),
    ("  __syncthreads();\n  for (int b = threadIdx.x; b < kBins; "
     "b += blockDim.x)\n    if (s_g[b] != s_gseen[b]) {",
     "  __syncthreads();\n"
     "  if (threadIdx.x == 0 && blockIdx.x < %d) wclk[4] = gtime();\n"
     "  for (int b = threadIdx.x; b < kBins; b += blockDim.x)\n"
     "    if (s_g[b] != s_gseen[b]) {" % ROWS),
    ("    if (run >= 0) atomicMin(&s_flat[run], fv);\n  }\n  __syncthreads();"
     "\n}\n",
     "    if (run >= 0) atomicMin(&s_flat[run], fv);\n  }\n  __syncthreads();"
     "\n  if (threadIdx.x == 0 && blockIdx.x < %d) wclk[2] = gtime();\n}\n"
     % ROWS),
    ("  const int groups = A.wedges * A.groups;\n  // The layout stays",
     "  const unsigned long long t_start = gtime();\n"
     "  unsigned long long t_p1 = 0, t_fold = 0;\n"
     "  const int groups = A.wedges * A.groups;\n  // The layout stays"),
    ("      if (cached) load_xy(A, S);  // read in phase 2, after the barrier"
     "\n    }\n",
     "      if (cached) load_xy(A, S);\n    }\n    t_p1 = gtime();\n"),
    ("  cooperative_groups::this_grid().sync();\n\n  // Phase 2",
     "  t_fold = gtime();\n  cooperative_groups::this_grid().sync();\n"
     "  const unsigned long long t_s1 = gtime();\n\n  // Phase 2"),
    ("  cooperative_groups::this_grid().sync();\n\n  // Phase 3",
     "  const unsigned long long t_p2 = gtime();\n"
     "  cooperative_groups::this_grid().sync();\n"
     "  const unsigned long long t_s2 = gtime();\n\n  // Phase 3"),
    # K13 (first_nonroad_kernel) records into the same array: each case
    # reads the rows of its own last launch.  s_clk: 0 start, 1 the
    # ticket known, 2 the first block's kf published or a block's poll
    # done, 3 the last slot thread's fold done (atomicMax).
    ("  __shared__ unsigned long long s_key[kBins];\n"
     "  const int tid = threadIdx.x;\n",
     "  __shared__ unsigned long long s_key[kBins];\n"
     "  __shared__ unsigned long long s_clk[4];\n"
     "  const int tid = threadIdx.x;\n"
     "  if (tid == 0) { s_clk[0] = gtime(); s_clk[2] = 0; s_clk[3] = 0; }\n"),
    ("    first_ticket = __shfl_sync(~0u, first_ticket, 0);\n",
     "    first_ticket = __shfl_sync(~0u, first_ticket, 0);\n"
     "    if (lane == 0) s_clk[1] = gtime();\n"),
    ("      while (load_acquire(&g_mf_first) <= ticket) {\n      }\n    }\n",
     "      while (load_acquire(&g_mf_first) <= ticket) {\n      }\n    }\n"
     "    if (lane == 0) s_clk[2] = gtime() | (first ? 1ULL << 63 : 0ULL);\n"),
    ("      first_fold(w, c, av, lv, s_key);\n    }\n  }\n  __syncthreads();\n",
     "      first_fold(w, c, av, lv, s_key);\n    }\n"
     "    atomicMax(&s_clk[3], gtime());\n  }\n  __syncthreads();\n"
     "  const unsigned long long t_sync = gtime();\n"),
    ("    if (s_key[b] != kNoKey) atomicMin(&kf[b], s_key[b]);\n}\n",
     "    if (s_key[b] != kNoKey) atomicMin(&kf[b], s_key[b]);\n"
     "  __syncthreads();\n  if (tid == 0) {\n"
     + _clock.record("g_clk_state", ROWS,
                     ("s_clk[0]", "s_clk[1]", "s_clk[2] & ~(1ULL << 63)",
                      "s_clk[3]", "t_sync", "gtime()", "s_clk[2] >> 63",
                      "gridDim.x"))
     + "  }\n}\n"),
    ("    A.state[(size_t)pair * 6 + sub] = val;\n  }\n}\n",
     "    A.state[(size_t)pair * 6 + sub] = val;\n  }\n  __syncthreads();\n"
     "  if (tid == 0) {\n"
     + _clock.record("g_clk_state", ROWS,
                     ("t_start", "t_p1", "t_fold", "t_s1", "t_p2", "t_s2",
                      "gtime()", "gridDim.x"))
     + "  }\n}\n"),
)
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the result as JSON")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("clock_flood_markers: needs a CUDA device")
    from urban_road_filter_torch import FilterConfig, _build

    def module(name, path):
        spec = importlib.util.spec_from_file_location(name, ROOT / path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    c = module("chip_smoke_helpers", "chip_smoke.py")
    prk = module("profile_ring_kernels", "tools/profile_ring_kernels.py")
    dev = torch.device("cuda", 0)
    cfg = FilterConfig(star_shaped_method=False)
    _build.library()
    clocked_lib = _clock.build(
        "clock_flood_markers",
        [("flood.cu", FLOOD, "urf_clock_blocked", "g_clk_blocked", ROWS),
         ("markers.cu", MARKERS, "urf_clock_state", "g_clk_state", ROWS)],
        plain=("group_place.cu",),
        entries=("urf_flood_blocked", "urf_marker_state",
                 "urf_marker_first_nonroad"))
    smi = _clock.card()
    print(smi, flush=True)

    name, dims, scan = prk.scan_shapes(c)[0]
    scan_calls = prk.scan_calls(dev, dims, cfg, scan)
    sp_calls = prk.sp_wedge_calls(dev, c, cfg)
    cases = [(f"K8 {name}", "blocked", scan_calls["flood_blocked"]),
             (f"K8 {name}, every slot a curb", "blocked",
              scan_calls["flood_blocked_all_curbs"]),
             ("K8 SP scan (8 x 128 x 384)", "blocked",
              sp_calls["flood_blocked"]),
             (f"K14 {name}", "state", scan_calls["marker_state"]),
             ("K14 SP scan, pass 2 (8 x 128 x 384)", "state",
              sp_calls["marker_state"]),
             (f"K13 {name}", "first", scan_calls["marker_first_nonroad"])]

    on = _clock.on

    def flat(res):
        if isinstance(res, torch.Tensor):
            return [res]
        return [t for r in res for t in flat(r)]

    out = {"card": smi}
    for what, kind, fn in cases:
        want = flat(fn())
        got = flat(on(clocked_lib, fn))
        assert all(torch.equal(g, w) for g, w in zip(got, want)), what
        torch.cuda.synchronize()
        r = _clock.read(clocked_lib, "urf_clock_blocked" if kind ==
                        "blocked" else "urf_clock_state", ROWS)
        grid = int(r[0, 6 if kind == "blocked" else 7])
        r = r[:min(grid, ROWS)]
        if kind == "first":
            t0, tt, tp, tf, tsync, te = (r[:, j] for j in range(6))
            one = r[:, 6] == 1
            rest = ~one
            res = {"grid": grid, "span_ns": int(te.max() - t0.min()),
                   "start_spread_ns": int(t0.max() - t0.min()),
                   "ticket_ns": int((tt - t0).max()),
                   "first_block_published_at_ns": int(tp[one].max()
                                                      - t0.min()),
                   "poll_done_at_ns": int(tp[rest].max() - t0.min())
                   if rest.any() else 0,
                   "fold_ns": int((tf - t0).max()),
                   "last_fold_done_at_ns": int(tf.max() - t0.min()),
                   "barrier_ns": int((tsync - np.maximum(tf, tp)).max()),
                   "atomics_issue_ns": int((te - tsync).max()),
                   "median_block_ns": int(np.median(te - t0))}
        elif kind == "blocked":
            t0, tl, tc, t1, ts, te = (r[:, j] for j in range(6))
            res = {"grid": grid, "span_ns": int(te.max() - t0.min()),
                   "start_spread_ns": int(t0.max() - t0.min()),
                   "loads_ns": int((tl - t0).max()),
                   "curbs_ns": int((tc - tl).max()),
                   "barrier_ns": int((t1 - tc).max()),
                   "scan_ns": int((ts - t1).max()),
                   "compare_and_store_ns": int((te - ts).max()),
                   "median_block_ns": int(np.median(te - t0))}
        else:
            t0, t1, tf, s1, t2, s2, te = (r[:, j] for j in range(7))
            res = {"grid": grid, "span_ns": int(te.max() - t0.min()),
                   "start_spread_ns": int(t0.max() - t0.min()),
                   "phase1_ns": int((t1 - t0).max()),
                   "write_f_ns": int((tf - t1).max()),
                   "arrival_spread_ns": int(tf.max() - tf.min()),
                   "barrier1_release_ns": int(s1.max() - tf.max()),
                   "phase2_ns": int((t2 - s1).max()),
                   "phase2_merge_f_ns": int((r[:, 9] - s1).max()),
                   "phase2_max_ns": int((r[:, 10] - r[:, 9]).max()),
                   "phase2_keys_ns": int((r[:, 11] - r[:, 10]).max()),
                   "phase2_forget_ns": int((r[:, 12] - r[:, 10]).max()),
                   "phase2_g_ns": int((r[:, 13] - r[:, 12]).max()),
                   "phase2_flat_ns": int((r[:, 11] - r[:, 13]).max()),
                   "phase2_write_ns": int((t2 - r[:, 11]).max()),
                   "barrier2_release_ns": int(s2.max() - t2.max()),
                   "phase3_ns": int((te - s2).max())}
        res["clocked_ms"] = on(clocked_lib, lambda: c.cuda_ms(fn, 20))
        res["ms"] = c.cuda_ms(fn, 20)
        out[what] = res
        print(f"{what}: {json.dumps(res)}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
