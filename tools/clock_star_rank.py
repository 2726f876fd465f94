#!/usr/bin/env python3
"""Where the star search (K4) and the group rank (K5) spend their time,
phase by phase, on one CUDA card.

    python tools/clock_star_rank.py [--out F.json]

Writes copies of urban_road_filter_torch/csrc/star.cu and group_place.cu
with %globaltimer reads (the card's nanosecond clock, one for every SM) at
the kernels' phase boundaries into the gitignored build directory,
compiles them with the port's nvcc flags into a library of their own and
runs the port's wrappers (ops.star.star_search, ops.rank.group_positions)
on it, on chip_smoke.py's inputs: K4 on the K1 keys of the OS1-64 drive
scan, a bench lane and a merged multi-LiDAR scan (phase 2), on the OS1-64
scan with every beam point in one beam, and on each of the 8 wedges of the
SP run of the OS1-128 scan (phase 5); K5 on the ring ids of the same three
scans, on the SP run's two calls (9 and 1025 groups) and on phase 2's
random ids over 2049 groups.  Every result is held bit-equal to the
unclocked kernel's.

Per input, in ns, from the blocks of the last launch: K4's span (first
block start to last block end), the partition (histogram; scatter), the
spread of the blocks' arrival at the grid barrier and its release after
the last arrival, then the walk phase of the slowest block and its split
into the run column, the chunk selection, the sort and the walk, with the
chunks it took.  K5's span, its tile histograms, the first barrier, the
column scans, the second barrier and the ranking, of which the ordered
32-step pass.  Beside them the CUDA-event time of the clocked and the
unclocked launch (median of 20), so the clocks' own cost shows.  The
clocks are patched in by text: the tool fails loudly when a source no
longer has the lines it anchors on.  Needs a CUDA device.
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

ROWS = 512  # blocks recorded


def _lap(acc):
    return ("{ const unsigned long long q = gtime(); " + acc
            + " += q - q0; q0 = q; }\n")


# (anchor, replacement) per source: each anchor must occur.
STAR = (
    ("namespace {\n\nconstexpr int kBeams = 360;",
     _clock.declare("g_clk_star", ROWS)
     + "namespace {\n\nconstexpr int kBeams = 360;"),
    ("  // 1. Partition each unit's points into its region, beam after "
     "beam.\n",
     "  const unsigned long long t_start = gtime();\n"
     "  unsigned long long t_hist = t_start;\n"
     "  unsigned long long p_col = 0, p_sel = 0, p_sort = 0, p_walk = 0;\n"
     "  int chunks = 0, nbeams = 0;\n"
     "  // 1. Partition each unit's points into its region, beam after "
     "beam.\n"),
    ("      if (in && (same & lt) == 0) atomicAdd(&s_cnt[f], __popc(same));\n"
     "    }\n    __syncthreads();\n",
     "      if (in && (same & lt) == 0) atomicAdd(&s_cnt[f], __popc(same));\n"
     "    }\n    __syncthreads();\n"
     "    t_hist = gtime();\n"),
    ("  cooperative_groups::this_grid().sync();\n\n"
     "  // 2. Walk each (lane, beam) pair.\n",
     "  const unsigned long long t_part = gtime();\n"
     "  cooperative_groups::this_grid().sync();\n"
     "  const unsigned long long t_sync = gtime();\n\n"
     "  // 2. Walk each (lane, beam) pair.\n"),
    ("    // The beam's runs (column b of the lane's rows) and their "
     "offsets.\n",
     "    unsigned long long q0 = gtime();\n    ++nbeams;\n"
     "    // The beam's runs (column b of the lane's rows) and their "
     "offsets.\n"),
    ("      before += cnt[k];\n    }\n    __syncthreads();\n",
     "      before += cnt[k];\n    }\n    __syncthreads();\n    "
     + _lap("p_col")),
    ("      __syncthreads();\n      const int m = s_n;\n",
     "      __syncthreads();\n      const int m = s_n;\n      ++chunks;\n      "
     + _lap("p_sel")),
    ("        srt = s_src;\n        srz = s_rzsrc;\n      }\n"
     "      __syncthreads();\n",
     "        srt = s_src;\n        srz = s_rzsrc;\n      }\n"
     "      __syncthreads();\n      " + _lap("p_sort")),
    ("      __syncthreads();\n      hit = s_hit;\n",
     "      __syncthreads();\n      hit = s_hit;\n      " + _lap("p_walk")),
    ("    if (tid == 0) a.hp[q] = hit;\n  }\n}\n",
     "    if (tid == 0) a.hp[q] = hit;\n  }\n"
     "  if (tid == 0 && blockIdx.x < 512) {\n"
     "    unsigned long long* d = g_clk_star + blockIdx.x * 16;\n"
     "    d[0] = t_start; d[1] = t_hist; d[2] = t_part; d[3] = t_sync;\n"
     "    d[4] = gtime(); d[5] = p_col; d[6] = p_sel; d[7] = p_sort;\n"
     "    d[8] = p_walk; d[9] = chunks; d[10] = nbeams; d[11] = gridDim.x;\n"
     "  }\n}\n"),
)
RANK = (
    ("namespace {\n\nconstexpr int kBlock = 1024;",
     _clock.declare("g_clk_rank", ROWS)
     + "namespace {\n\nconstexpr int kBlock = 1024;"),
    ("  // 1. Tile histograms;",
     "  const unsigned long long t_start = gtime();\n"
     "  unsigned long long p_ord = 0;\n  // 1. Tile histograms;"),
    ("  cooperative_groups::this_grid().sync();\n\n  // 2. Per (scan, group)",
     "  const unsigned long long t_hist = gtime();\n"
     "  cooperative_groups::this_grid().sync();\n"
     "  const unsigned long long t_s1 = gtime();\n\n"
     "  // 2. Per (scan, group)"),
    ("  cooperative_groups::this_grid().sync();\n\n  // 3. Stable ranks",
     "  const unsigned long long t_scan = gtime();\n"
     "  cooperative_groups::this_grid().sync();\n"
     "  const unsigned long long t_s2 = gtime();\n\n  // 3. Stable ranks"),
    ("    int base = 0;\n    for (int w = 0; w < kWarps; ++w) {",
     "    const unsigned long long o0 = gtime();\n"
     "    int base = 0;\n    for (int w = 0; w < kWarps; ++w) {"),
    ("    base = __shfl_sync(~0u, base, leader);\n",
     "    base = __shfl_sync(~0u, base, leader);\n"
     "    p_ord += gtime() - o0;\n"),
    ("    if (i < a.n) a.pos[at] = in ? base + __popc(same & lt) : -1;\n"
     "    __syncthreads();\n  }\n}\n",
     "    if (i < a.n) a.pos[at] = in ? base + __popc(same & lt) : -1;\n"
     "    __syncthreads();\n  }\n"
     "  if (threadIdx.x == 0 && blockIdx.x < 512) {\n"
     "    unsigned long long* d = g_clk_rank + blockIdx.x * 16;\n"
     "    d[0] = t_start; d[1] = t_hist; d[2] = t_s1; d[3] = t_scan;\n"
     "    d[4] = t_s2; d[5] = gtime(); d[6] = p_ord; d[7] = gridDim.x;\n"
     "  }\n}\n"),
)
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the result as JSON")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("clock_star_rank: needs a CUDA device")
    from urban_road_filter_torch import FilterConfig, _build, pad_scan
    from urban_road_filter_torch.ops import geometry, ingest, star
    from urban_road_filter_torch.ops.rank import group_positions
    from urban_road_filter_torch.parallel.azimuth_parallel import (
        make_azimuth_pipeline)

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
    _build.library()
    clocked_lib = _clock.build(
        "clock_star_rank",
        [("star.cu", STAR, "urf_clock_star", "g_clk_star", ROWS),
         ("group_place.cu", RANK, "urf_clock_rank", "g_clk_rank", ROWS)],
        entries=("urf_star_search", "urf_group_rank"))
    smi = _clock.card()
    print(smi, flush=True)

    # The inputs, made with the unclocked kernels.
    k4_in, k5_in = [], []
    for name, dims, scan in prk.scan_shapes(c):
        pts = torch.from_numpy(pad_scan(scan, dims.max_points)).to(dev)
        x, y, z, _ = geometry.xyz_of(pts, "rows")
        _, fk, rk, _ = ingest.ingest_prep(x[None], y[None], z[None], cfg)
        k4_in.append((name, fk[0], rk[0], pts[:, 2]))
        if name == "os1_64":
            one = torch.where(fk[0] < 360, 7, fk[0])
            k4_in.append(("os1_64 one beam", one, rk[0], pts[:, 2]))
        x, y, z = x.contiguous(), y.contiguous(), z.contiguous()
        valid = geometry.roi_mask_xyz(x, y, z, cfg)
        _, alpha = geometry.vertical_angles(x, y, z)
        angles, _ = geometry.discover_rings(alpha, valid, cfg.interval,
                                            rings=dims.rings)
        ids = geometry.assign_rings(alpha, valid, angles, cfg.interval)
        k5_in.append((f"{name} ({dims.rings + 1} groups)", ids,
                      dims.rings + 1))
    _, sp_dims, sp_scan, _ = c.sp_deployments()[0]
    probe = {}
    make_azimuth_pipeline(c.WEDGES, cfg, sp_dims, device=dev)(
        torch.from_numpy(pad_scan(sp_scan, sp_dims.max_points)).to(dev),
        probe=probe)
    xw, yw, zw, vw, fkw, rkw = probe["star"]
    for k in range(c.WEDGES):
        fk, rk = star._star_keys(xw[k], yw[k], zw[k], vw[k], cfg,
                                 (fkw[k], rkw[k]))
        k4_in.append((f"SP wedge {k}", fk, rk, zw[k]))
    for groups, ids in sorted(probe["rank_ids"].items()):
        k5_in.append((f"SP ({groups} groups)", ids, groups))
    n = sp_dims.max_points
    k5_in.append(("random (2049 groups)",
                  torch.from_numpy(c.rank_ids(n, 2049)).to(dev), 2049))

    on = _clock.on

    def read(fn, grid_col):
        """The clock rows of the last launch's blocks (the grid size sits
        in column grid_col)."""
        rows = _clock.read(clocked_lib, fn, ROWS)
        return rows[:int(rows[0, grid_col])]

    def event_ms(fn):
        return {"clocked_ms": on(clocked_lib, lambda: c.cuda_ms(fn, 20)),
                "ms": c.cuda_ms(fn, 20)}

    out = {"card": smi, "star_search": {}, "group_rank": {}}
    for name, fk, rk, z in k4_in:
        fn = lambda: star.star_search(fk, rk, z, cfg)
        want = fn()
        got = on(clocked_lib, fn)
        assert torch.equal(got, want), name
        torch.cuda.synchronize()
        r = read("urf_clock_star", 11)
        t0, th, tp, ts, te = (r[:, j] for j in range(5))
        slow = int(np.argmax(te - ts))
        res = {"grid": len(r), "span_ns": int(te.max() - t0.min()),
               "start_spread_ns": int(t0.max() - t0.min()),
               "histogram_ns": int((th - t0).max()),
               "scatter_ns": int((tp - th).max()),
               "arrival_spread_ns": int(tp.max() - tp.min()),
               "barrier_release_ns": int(ts.max() - tp.max()),
               "walk_phase_ns": int((te - ts).max()),
               "slowest": dict(zip(("column_ns", "select_ns", "sort_ns",
                                    "walk_ns", "chunks", "beams"),
                                   map(int, r[slow, 5:11]))),
               "median_block": dict(zip(("column_ns", "select_ns",
                                         "sort_ns", "walk_ns"),
                                        map(int, np.median(r[:, 5:9],
                                                           axis=0)))),
               **event_ms(fn)}
        out["star_search"][name] = res
        print(f"K4 {name}: {json.dumps(res)}", flush=True)
    for name, ids, groups in k5_in:
        fn = lambda: group_positions(ids, groups)
        want = fn()
        got = on(clocked_lib, fn)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), name
        torch.cuda.synchronize()
        r = read("urf_clock_rank", 7)
        t0, th, t1, tc, t2, te, po = (r[:, j] for j in range(7))
        res = {"grid": len(r), "span_ns": int(te.max() - t0.min()),
               "start_spread_ns": int(t0.max() - t0.min()),
               "histogram_ns": int(th.max() - t0.min()),
               "barrier1_ns": int(t1.max() - th.max()),
               "column_scan_ns": int((tc - t1).max()),
               "barrier2_ns": int(t2.max() - tc.max()),
               "rank_ns": int((te - t2).max()),
               "ordered_pass_ns": int(po.max()),
               **event_ms(fn)}
        out["group_rank"][name] = res
        print(f"K5 {name}: {json.dumps(res)}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
