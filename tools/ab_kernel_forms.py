#!/usr/bin/env python3
"""The forms of K1 (ingest_prep) and K11 (gather_pack) against each other
on one CUDA card, each on the calls that take it.

    python tools/ab_kernel_forms.py [--out F.json]

K1's entry point picks a form per call: two points a thread, point by
point, for calls that fit one wave of blocks, else 8 points a thread with
a read mode (a float4 per point for rows of 4 floats, a float4 per plane
for planes, else point by point, "strided"); K11's takes one point a
thread for one lane and 4 for more.  This tool builds a copy of the two sources with the choice
overridable (``urf_force_prep(pts, strided)``, ``urf_force_gather(
general)``; tools/_clock.py's patch-and-build, no clocks) and, per call
shape, times every form the call could take, in turns (the forms, then
the same forms in reverse order): the device ms per launch (the kernel's
summed durations over its events, torch.profiler over 50 calls after
warm-up).  Each forced form's outputs are held bit-equal to the normal
library's first.  Shapes: K1 at B = 1 on the OS1-64 drive scan (rows,
131072 points), at the SP call's shape (262144 rows), and on the phase-4
batch (128 x 131072) as rows of 4 floats and as planes; K11 on the
OS1-64 scan (64 x 4096) and a bench lane (64 x 2048).  Prints the card's
name and power limit and one JSON line.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import _clock  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CALLS = 50

FORCE_PREP = [
    ('extern "C" int urf_ingest_prep(',
     "static int g_force_pts = 0, g_force_strided = 0;\n"
     'extern "C" void urf_force_prep(int pts, int strided) {\n'
     "  g_force_pts = pts;\n  g_force_strided = strided;\n}\n\n"
     'extern "C" int urf_ingest_prep('),
    ("  const int pts = (m + t2 - 1)",
     "  const int pts = g_force_pts ? g_force_pts : (m + t2 - 1)"),
    ("  const bool rows4 = point_stride == 4",
     "  const bool rows4 = !g_force_strided && point_stride == 4"),
    ("    launch = point_stride == 1 ?",
     "    launch = point_stride == 1 && !g_force_strided ?"),
]
FORCE_GATHER = [
    ('extern "C" int urf_gather_pack(',
     "static int g_force_general = 0;\n"
     'extern "C" void urf_force_gather(int general) {\n'
     "  g_force_general = general;\n}\n\n"
     'extern "C" int urf_gather_pack('),
    ("  if (lanes == 1)\n", "  if (lanes == 1 && !g_force_general)\n"),
]

# (name, points per thread, 2 or 8 (0: the entry point's choice), strided)
SCAN_FORMS = [("auto", 0, 0), ("pts8", 8, 0), ("pts8_strided", 8, 1)]
BATCH_FORMS = [("auto", 0, 0), ("strided", 0, 1)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the result as JSON")
    args = ap.parse_args()
    import ctypes

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("ab_kernel_forms: needs a CUDA device")
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
    _build.library()
    lib = _clock.build("ab_kernel_forms",
                       [("ingest.cu", FORCE_PREP, None, None, 0),
                        ("gather_pack.cu", FORCE_GATHER, None, None, 0)],
                       plain=("group_place.cu",),
                       entries=("urf_ingest_prep", "urf_gather_pack"))
    lib.urf_force_prep.argtypes = (ctypes.c_int, ctypes.c_int)
    lib.urf_force_gather.argtypes = (ctypes.c_int,)
    smi = _clock.card()
    print(smi, flush=True)

    def per_launch_ms(fn, kernel: str) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        us, count = 0.0, 0
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and kernel in e.key:
                t = getattr(e, "self_device_time_total", None)
                us += e.self_cuda_time_total if t is None else t
                count += e.count
        return us / count / 1e3

    def in_turns(fn, forms, force, kernel):
        want = fn()
        res = {name: [] for name, *_ in forms}
        for order in (forms, forms[::-1]):
            for name, *knobs in order:
                force(*knobs)
                got = _clock.on(lib, fn)
                assert all(torch.equal(g, w) for g, w in zip(got, want)), (
                    name, kernel)
                res[name].append(_clock.on(
                    lib, lambda: per_launch_ms(fn, kernel)))
        force(*(0 for _ in forms[0][1:]))
        return res

    n64 = PipelineDims.for_sensor("os1-64").max_points
    rows = torch.from_numpy(pad_scan(c.os1_64_scan(), n64)).to(dev)
    b1 = [v[None] for v in geometry.xyz_of(rows, "rows")[:3]]
    _, sp_dims, sp_scan, _ = c.sp_deployments()[0]
    sp, _, _ = c.sp_ring_inputs(dev, cfg,
                                pad_scan(sp_scan, sp_dims.max_points))
    batch = np.stack([pad_scan(s, 131072) for s in c.bench_scans(c.BATCH)])
    b128_rows = geometry.xyz_of(torch.from_numpy(batch).to(dev), "rows",
                                batched=True)[:3]
    b128_planar = geometry.xyz_of(
        torch.from_numpy(planarize_batch(batch)).to(dev), "planar",
        batched=True)[:3]
    force_prep = lambda pts, strided: lib.urf_force_prep(pts, strided)
    out = {"card": smi, "ingest_prep": {}, "gather_pack": {}}
    for what, xyz, forms in (("b1_rows", b1, SCAN_FORMS),
                             ("sp_rows", sp, SCAN_FORMS),
                             ("b128_rows", b128_rows, BATCH_FORMS),
                             ("b128_planar", b128_planar, BATCH_FORMS)):
        res = in_turns(lambda: ingest.ingest_prep(*xyz, cfg), forms,
                       force_prep, "ingest_prep_kernel")
        out["ingest_prep"][what] = res
        print("ingest_prep", what, json.dumps(res), flush=True)
    del b128_rows, b128_planar
    for name, dims, host in prk.scan_shapes(c)[:2]:
        fn = prk.scan_calls(dev, dims, cfg, host)["gather_pack"]
        res = in_turns(fn, [("auto", 0), ("general", 1)],
                       lambda general: lib.urf_force_gather(general),
                       "gather_pack_kernel")
        out["gather_pack"][name] = res
        print("gather_pack", name, json.dumps(res), flush=True)
    print(json.dumps(out))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
