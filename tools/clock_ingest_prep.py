#!/usr/bin/env python3
"""Where the ingest prep (K1) spends its time, on one CUDA card: its loads,
its float64 atan2, its stores and its in-ROI count.

    python tools/clock_ingest_prep.py [TREE] [--out F.json]

TREE is a checkout of this repository (default: this one).  Writes a copy
of TREE's urban_road_filter_torch/csrc/ingest.cu with %globaltimer reads
(the card's nanosecond clock) patched into ingest_prep_kernel into the
gitignored build directory, compiles it with the port's nvcc flags into a
library of its own and runs TREE's wrapper on it, on the K1 inputs of
tools/profile_ring_kernels.py: one OS1-64 drive scan at B = 1 (rows), the
SP call's shape (one 262144-point OS1-128 scan, rows) and the phase-4
batch (128 planar scans of 131072 points).  Every result is held
bit-equal to the unclocked kernel's.  Two kernel forms are known: one
thread per point (trees before the redesign; the counts zeroed by a fill)
and, since, two points a thread for calls that fit in one wave,
two 4-point vectors a thread for larger ones, and a ticket warp per block
(the counts zeroed by the launch's first block).

Per input, from the blocks of the last launch: the span (first block start
to last block end), per block (median and max) the ticket lane (new form:
its ticket, the first block's zeroing, the wait for it), the vector loop,
the point-by-point loop (two points a thread, in the new form's small
calls) and the count (the block sum and its barrier); and
from each block's thread 0, summed over the blocks: the wait for its
first loads (issue to first use), the float64 atan2 with the root and the
sector (per call and in all), and the issue of its stores.  Beside them
the CUDA-event time of the clocked and the unclocked launch (median of
20), so the clocks' own cost shows.  The tool fails loudly when the
kernel no longer has the lines it anchors on.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import _clock  # noqa: E402

ROWS = 65536  # blocks recorded
NAME = "g_clk_prep"
READER = "urf_clock_prep"
# Thread 0's fields, in this order: block start, the ticket lane done
# (block start in the per-point kernel, which has none), the vector loop
# done, the point loop done, end (after the block sum's barrier), its
# first-load waits, atan2 ns, store-issue ns, atan2 calls, grid.x.
FIELDS = ("t_start", "t_ticket", "t_vec", "t_scalar", "gtime()", "c_load",
          "c_atan", "c_store", "n_atan", "gridDim.x")
ROW = "blockIdx.y * gridDim.x + blockIdx.x"
USE = 'asm volatile("" :: "r"((int)v));\n'  # v computed before the clock

DECLARE = ("namespace {\n\nconstexpr int kStarRep = 360;",
           _clock.declare(NAME, ROWS)
           + "namespace {\n\nconstexpr int kStarRep = 360;")

# The redesigned kernel: two points a thread, or two 4-point
# vectors a thread, then point by point (prep_points); a ticket warp per
# block.  clk: first-load wait, atan2 ns, store-issue ns, atan2 calls.
STRIDED = (
    DECLARE,
    ("                                             bool* vb, int* fb, "
     "float* rb) {\n  const bool v = in_roi(xx, yy, zz, roi);\n",
     "                                             bool* vb, int* fb, "
     "float* rb,\n"
     "                                             unsigned long long* clk,\n"
     "                                             unsigned long long t_issue)"
     " {\n  const bool v = in_roi(xx, yy, zz, roi);\n  " + USE
     + "  if (t_issue) clk[0] += gtime() - t_issue;\n"
     "  const unsigned long long t1 = gtime();\n"
     "  unsigned long long t_at = 0;\n"),
    ("    if (v) star_key(xx, yy, kfi, f, r);\n",
     "    const unsigned long long ta = gtime();\n"
     "    if (v) star_key(xx, yy, kfi, f, r);\n"
     '    asm volatile("" :: "r"(f), "f"(r));\n'
     "    t_at = gtime() - ta;\n    clk[1] += t_at;\n    clk[3] += v;\n"),
    ("    rb[i] = r;\n  }\n  return v;\n",
     "    rb[i] = r;\n  }\n  clk[2] += gtime() - t1 - t_at;\n"
     "  return v;\n"),
    ("    float* __restrict__ r_key, int b, int tid, int stride) {\n",
     "    float* __restrict__ r_key, int b, int tid, int stride,\n"
     "    unsigned long long* clk, unsigned long long& t_vec) {\n"
     "  unsigned long long t_issue = 0;\n"),
    ("    float px[kPts], py[kPts], pz[kPts];\n",
     "    float px[kPts], py[kPts], pz[kPts];\n    t_issue = gtime();\n"),
    ("                            want_keys, vb, fb, rb);\n",
     "                            want_keys, vb, fb, rb, clk,\n"
     "                            u == 0 ? t_issue : 0);\n"),
    ("    float px[2][4], py[2][4], pz[2][4];\n",
     "    float px[2][4], py[2][4], pz[2][4];\n    t_issue = gtime();\n"),
    ("        const bool v = in_roi(px[u][e], py[u][e], pz[u][e], roi);\n",
     "        const bool v = in_roi(px[u][e], py[u][e], pz[u][e], roi);\n"
     "        if (u == 0 && e == 0) {\n          " + USE
     + "          clk[0] += gtime() - t_issue;\n        }\n"),
    ("        if (want_keys && v) star_key(px[u][e], py[u][e], kfi, f[e], "
     "r[e]);\n",
     "        const unsigned long long ta = gtime();\n"
     "        if (want_keys && v) star_key(px[u][e], py[u][e], kfi, f[e], "
     "r[e]);\n"
     '        asm volatile("" :: "r"(f[e]), "f"(r[e]));\n'
     "        clk[1] += gtime() - ta;\n        clk[3] += want_keys && v;\n"),
    ("      *reinterpret_cast<unsigned*>(vb + i) = v4;\n",
     "      const unsigned long long ts = gtime();\n"
     "      *reinterpret_cast<unsigned*>(vb + i) = v4;\n"),
    ("            make_float4(r[0], r[1], r[2], r[3]);\n      }\n",
     "            make_float4(r[0], r[1], r[2], r[3]);\n      }\n"
     "      clk[2] += gtime() - ts;\n"),
    ("  // Point by point: [0, head), then [head + 4 nvec, n).\n",
     "  t_vec = gtime();\n"
     "  // Point by point: [0, head), then [head + 4 nvec, n).\n"),
    ("    load_point(xb, yb, zb, i, point_stride, xx, yy, zz);\n"
     "    cnt += finish_point(xx, yy, zz, i, roi, kfi, want_keys, vb, fb, "
     "rb);\n",
     "    const unsigned long long tl = gtime();\n"
     "    load_point(xb, yb, zb, i, point_stride, xx, yy, zz);\n"
     "    cnt += finish_point(xx, yy, zz, i, roi, kfi, want_keys, vb, fb, rb,"
     " clk,\n                        tl);\n"),
    ("  __shared__ int warp_cnt[kThreads / 32];\n",
     "  __shared__ int warp_cnt[kThreads / 32];\n"
     "  __shared__ unsigned long long s_ticket;\n"
     "  const unsigned long long t_start = gtime();\n"
     "  unsigned long long clk[4] = {0, 0, 0, 0}, t_vec = t_start,"
     " t_scalar = t_start;\n"),
    ("    if (threadIdx.x == kThreads) counts_ready(piece);\n",
     "    if (threadIdx.x == kThreads) {\n      counts_ready(piece);\n"
     "      s_ticket = gtime();\n    }\n"),
    ("        gridDim.x * kThreads);\n",
     "        gridDim.x * kThreads, clk, t_vec);\n"
     "    t_scalar = gtime();\n"),
    ("  __syncthreads();\n  if (threadIdx.x == kThreads) {\n",
     "  __syncthreads();\n  if (threadIdx.x == 0) {\n"
     "    const unsigned long long t_ticket = s_ticket, c_load = clk[0],"
     " c_atan = clk[1], c_store = clk[2], n_atan = clk[3];\n"
     + _clock.record(NAME, ROWS, FIELDS, at=ROW)
     + "  }\n  if (threadIdx.x == kThreads) {\n"),
)

# The kernel before the redesign: one thread per point, no loop.
PER_POINT = (
    DECLARE,
    ("  const int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
     "  bool v = false;\n",
     "  const int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
     "  bool v = false;\n"
     "  const unsigned long long t_start = gtime(), t_ticket = t_start;\n"
     "  unsigned long long c_load = 0, c_atan = 0, c_store = 0, n_atan = 0,"
     " t_vec = t_start;\n"),
    ("    const long long o = (long long)b * n + i;\n    valid[o] = v;\n",
     "    " + USE + "    c_load = gtime() - t_start;\n"
     "    const unsigned long long ts = gtime();\n"
     "    const long long o = (long long)b * n + i;\n    valid[o] = v;\n"),
    ("      if (v) {\n        r = __fsqrt_rn",
     "      const unsigned long long ta = gtime();\n"
     "      if (v) {\n        r = __fsqrt_rn"),
    ("      fk[o] = f;\n      r_key[o] = r;\n    }\n  }\n",
     '      asm volatile("" :: "r"(f), "f"(r));\n'
     "      c_atan = gtime() - ta;\n      n_atan = v;\n"
     "      fk[o] = f;\n      r_key[o] = r;\n    }\n"
     "    c_store = gtime() - ts - c_atan;\n    t_vec = gtime();\n  }\n"
     "  const unsigned long long t_scalar = t_vec;\n"),
    ("  if (threadIdx.x == 0 && cnt > 0) atomicAdd(&piece[b], cnt);\n",
     "  if (threadIdx.x == 0 && cnt > 0) atomicAdd(&piece[b], cnt);\n"
     "  if (threadIdx.x == 0) {\n"
     + _clock.record(NAME, ROWS, FIELDS, at=ROW) + "  }\n"),
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", nargs="?", default=str(ROOT))
    ap.add_argument("--out", default=None, help="write the result as JSON")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("clock_ingest_prep: needs a CUDA device")
    from urban_road_filter_torch import (
        FilterConfig, PipelineDims, _build, pad_scan, planarize_batch)
    from urban_road_filter_torch.ops import geometry, ingest

    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  ROOT / "chip_smoke.py")
    c = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(c)
    _clock.CSRC = tree / "urban_road_filter_torch/csrc"
    source = (_clock.CSRC / "ingest.cu").read_text()
    patches = STRIDED if "counts_ready" in source else PER_POINT
    dev = torch.device("cuda", 0)
    cfg = FilterConfig()
    _build.library()
    lib = _clock.build("clock_ingest_prep",
                       [("ingest.cu", patches, READER, NAME, ROWS)],
                       plain=("group_place.cu",),
                       entries=("urf_ingest_prep",))
    smi = _clock.card()
    print(smi, "kernel form:",
          "strided" if patches is STRIDED else "per point", flush=True)

    n64 = PipelineDims.for_sensor("os1-64").max_points
    rows = torch.from_numpy(pad_scan(c.os1_64_scan(), n64)).to(dev)
    b1 = [v[None] for v in geometry.xyz_of(rows, "rows")[:3]]
    _, sp_dims, sp_scan, _ = c.sp_deployments()[0]
    sp, _, _ = c.sp_ring_inputs(dev, cfg,
                                pad_scan(sp_scan, sp_dims.max_points))
    planar = torch.from_numpy(planarize_batch(np.stack(
        [pad_scan(s, 131072) for s in c.bench_scans(c.BATCH)]))).to(dev)
    b128 = geometry.xyz_of(planar, "planar", batched=True)[:3]
    cases = [("B=1 OS1-64 rows", b1), ("SP call (1, 262144) rows", sp),
             ("B=128 phase-4 planar", b128)]

    out = {"card": smi, "tree": str(tree),
           "form": "strided" if patches is STRIDED else "per point"}
    for what, xyz in cases:
        fn = lambda: ingest.ingest_prep(*xyz, cfg)
        want = fn()
        got = _clock.on(lib, fn)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), what
        torch.cuda.synchronize()
        r = _clock.read(lib, READER, ROWS)
        gx, gy = ingest.last_grid["ingest_prep"]
        r = r[:min(gx * gy, ROWS)]
        t0, tt, tv, ts, te, cl, ca, cs, na = (r[:, j] for j in range(9))

        def stat(d):
            return {"median": int(np.median(d)), "max": int(d.max())}

        res = {"grid": [gx, gy], "blocks_recorded": len(r),
               "span_ns": int(te.max() - t0.min()),
               "start_spread_ns": int(t0.max() - t0.min()),
               "block_ns": stat(te - t0), "ticket_ns": stat(tt - t0),
               "vector_loop_ns": stat(tv - t0),
               "point_loop_ns": stat(ts - tv), "count_ns": stat(te - ts),
               "thread0_first_load_wait_ns": int(cl.sum()),
               "thread0_atan2_ns": int(ca.sum()),
               "thread0_atan2_calls": int(na.sum()),
               "atan2_ns_per_call": float(ca.sum() / max(int(na.sum()), 1)),
               "thread0_store_issue_ns": int(cs.sum()),
               "thread0_busy_ns": int((te - t0).sum())}
        res["clocked_ms"] = _clock.on(lib, lambda: c.cuda_ms(fn, 20))
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
