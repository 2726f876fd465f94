#!/usr/bin/env python3
"""Where ring discovery (K2) spends its cycles, phase by phase, on one CUDA
card.

    python tools/clock_ring_discovery.py

Writes a copy of urban_road_filter_torch/csrc/ingest.cu with clock64()
reads at K2's phase boundaries into the gitignored build directory,
compiles it with the port's nvcc flags and runs it on chip_smoke.py's
inputs: one OS1-64 drive scan at B = 1 and reordered ring-major, the SP
call's shape (262144 points, 128 rings, valid0 & fits), two merged
multi-LiDAR scans and the phase-4 batch (B = 128, also with the ring cap
24).  For the finishing block of each of the first scans it prints, in
SM cycles: the prefix greedy, the filter, the arrival, the finishing
walk (of it: compacting the marked chunks, resolving the list), the
output; the rounds of the prefix and in all; the chunks compacted.
Every result is held bit-equal to the plain twin.  The clocks are
patched in by text: the tool fails loudly when ingest.cu no longer has
the lines it anchors on.  Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FIELDS = ("prefix", "filter", "arrive", "walk", "output", "rounds_prefix",
          "rounds", "chunks", "count", "compact", "lists")

# (anchor in csrc/ingest.cu, replacement): each anchor must occur.
PATCHES = (
    ("namespace {\n\nconstexpr int kStarRep",
     "__device__ long long g_clk[256 * 16];\n__shared__ int g_rounds;\n"
     "__shared__ long long g_part[2];\nnamespace {\n\nconstexpr int kStarRep"),
    ("  while (true) {\n    bool any = false;",
     "  while (true) {\n    if (threadIdx.x == 0) ++g_rounds;\n"
     "    bool any = false;"),
    ("        // Append the chunk's marked points to the list, in input "
     "order.\n",
     "        ++chunks;\n        const long long h0 = clock64();\n"),
    ("        list = sh.count;\n        __syncthreads();\n",
     "        list = sh.count;\n        __syncthreads();\n"
     "        if (threadIdx.x == 0) g_part[0] += clock64() - h0;\n"),
    ("          finish_list(sh, list, size, rings, tol);\n          list = 0;",
     "          const long long f0 = clock64();\n"
     "          finish_list(sh, list, size, rings, tol);\n"
     "          if (threadIdx.x == 0) g_part[1] += clock64() - f0;\n"
     "          list = 0;"),
    ("    finish_list(sh, list, size, rings, tol);\n\n",
     "  {\n    const long long f0 = clock64();\n"
     "    finish_list(sh, list, size, rings, tol);\n"
     "    if (threadIdx.x == 0) g_part[1] += clock64() - f0;\n  }\n\n"),
    ("  const int size = search_size(rings);\n  for (int m",
     "  const int size = search_size(rings);\n"
     "  const long long t_start = clock64();\n"
     "  if (threadIdx.x == 0) g_rounds = 0, g_part[0] = g_part[1] = 0;\n"
     "  for (int m"),
    ("  const int k_prefix = sh.n;\n",
     "  const int k_prefix = sh.n;\n  const long long t_prefix = clock64();\n"
     "  const int r_prefix = g_rounds;\n"),
    ("  // 3. The last block of the scan finishes it.\n  __threadfence();",
     "  // 3. The last block of the scan finishes it.\n"
     "  const long long t_filter = clock64();\n  __threadfence();"),
    ("  if (!sh.last) return;\n  __threadfence();\n",
     "  if (!sh.last) return;\n  __threadfence();\n"
     "  const long long t_arrive = clock64();\n  int chunks = 0;\n"),
    ("  // The sorted table, with the fill's",
     "  __syncthreads();\n  const long long t_walk = clock64();\n"
     "  // The sorted table, with the fill's"),
    ("  if (threadIdx.x == 0) count[b] = ns + nfill;\n}",
     "  if (threadIdx.x == 0) count[b] = ns + nfill;\n  __syncthreads();\n"
     "  if (threadIdx.x == 0 && b < 256) {\n"
     "    long long* d = g_clk + b * 16;\n"
     "    d[0] = t_prefix - t_start; d[1] = t_filter - t_prefix;\n"
     "    d[2] = t_arrive - t_filter; d[3] = t_walk - t_arrive;\n"
     "    d[4] = clock64() - t_walk; d[5] = r_prefix; d[6] = g_rounds;\n"
     "    d[7] = chunks; d[8] = ns + nfill; d[9] = g_part[0];\n"
     "    d[10] = g_part[1];\n  }\n}"),
)


def clocked_source() -> str:
    src = (ROOT / "urban_road_filter_torch/csrc/ingest.cu").read_text()
    for anchor, text in PATCHES:
        if anchor not in src:
            raise SystemExit(f"clock_ring_discovery: ingest.cu lacks {anchor!r}")
        src = src.replace(anchor, text, 1)
    return src + (
        '\nextern "C" int urf_clock_read(long long* host, int n) {\n'
        "  return (int)cudaMemcpyFromSymbol(host, g_clk, "
        "sizeof(long long) * n);\n}\n")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("clock_ring_discovery: needs a CUDA device")
    from urban_road_filter_torch import (
        FilterConfig, PipelineDims, _build, pad_scan, planarize_batch)
    from urban_road_filter_torch.ops import geometry, ingest

    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  ROOT / "chip_smoke.py")
    c = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(c)

    out = _build.BUILD_DIR / "clock_ring_discovery"
    out.mkdir(parents=True, exist_ok=True)
    (out / "ingest_clocked.cu").write_text(clocked_source())
    lib_path = out / "libclocked.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                          str(lib_path), str(out / "ingest_clocked.cu")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        sys.exit(res.stdout + res.stderr)
    for line in (res.stdout + res.stderr).splitlines():
        if "Used" in line:
            print(line.strip())
    lib = ctypes.CDLL(str(lib_path))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.urf_discover_rings.argtypes = (P, P, I, I, F, I, P, P, P, P, P)
    lib.urf_clock_read.argtypes = (P, I)
    dev = torch.device("cuda", 0)
    cfg = FilterConfig(star_shaped_method=False)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)

    def run(name, alpha, valid, rings):
        b, n = alpha.shape
        angles = torch.empty((b, rings), dtype=torch.float32, device=dev)
        count = torch.empty((b,), dtype=torch.int32, device=dev)
        scratch = torch.empty((b * (1 + (n + 31) // 32),), dtype=torch.int32,
                              device=dev)
        grid = (ctypes.c_int * 2)()
        for _ in range(3):  # the last launch's clocks are read
            err = lib.urf_discover_rings(
                P(alpha.data_ptr()), P(valid.data_ptr()), b, n,
                F(cfg.interval), rings, P(angles.data_ptr()),
                P(count.data_ptr()), P(scratch.data_ptr()),
                P(ctypes.addressof(grid)),
                P(torch.cuda.current_stream().cuda_stream))
            assert err == 0, err
            torch.cuda.synchronize()
        want = ingest.discover_rings_plain(alpha, valid, cfg.interval, rings)
        assert torch.equal(angles.view(torch.int32),
                           want[0].view(torch.int32))
        assert torch.equal(count, want[1])
        buf = (ctypes.c_longlong * (256 * 16))()
        assert lib.urf_clock_read(P(ctypes.addressof(buf)), 256 * 16) == 0
        rows = np.frombuffer(buf, dtype=np.int64).reshape(256, 16)
        print(f"{name}: grid {tuple(grid)}, bit-equal to the twin")
        for row in rows[:min(b, 2)]:
            print("  " + ", ".join(f"{k} {v}" for k, v in zip(FIELDS, row)))

    def rows_input(rows):
        x, y, z, _ = geometry.xyz_of(rows, "rows", batched=rows.ndim == 3)
        valid = geometry.roi_mask_xyz(x, y, z, cfg)
        _, alpha = geometry.vertical_angles(x, y, z)
        if alpha.ndim == 1:
            alpha, valid = alpha[None], valid[None]
        return alpha.contiguous(), valid.contiguous()

    n64 = PipelineDims.for_sensor("os1-64").max_points
    scan = c.os1_64_scan()
    run("OS1-64 scan, B = 1", *rows_input(
        torch.from_numpy(pad_scan(scan, n64)).to(dev)), 64)
    run("OS1-64 scan ring-major", *rows_input(
        torch.from_numpy(pad_scan(c.ring_major(scan), n64)).to(dev)), 64)
    _, sp_dims, sp_scan, _ = c.sp_deployments()[0]
    _, alpha, valid = c.sp_ring_inputs(
        dev, cfg, pad_scan(sp_scan, sp_dims.max_points))
    run("SP call", alpha, valid, sp_dims.rings)
    merged = torch.from_numpy(np.stack([pad_scan(s, 262144) for s in
                                        c.multi_lidar_scans()[:2]])).to(dev)
    run("2 merged multi-LiDAR scans", *rows_input(merged), 128)
    planar = torch.from_numpy(planarize_batch(np.stack(
        [pad_scan(s, 131072) for s in c.bench_scans(c.BATCH)]))).to(dev)
    x, y, z, _ = geometry.xyz_of(planar, "planar", batched=True)
    valid = geometry.roi_mask_xyz(x, y, z, cfg)
    _, alpha = geometry.vertical_angles(x, y, z)
    run("B = 128", alpha, valid, 64)
    run("B = 128, ring cap 24", alpha, valid, 24)
    return 0


if __name__ == "__main__":
    sys.exit(main())
