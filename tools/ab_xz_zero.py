#!/usr/bin/env python3
"""Forms of K7 (csrc/xz_zero.cu) against each other on one CUDA card.

    python tools/ab_xz_zero.py [--out F.json] [--sass DIR]

Builds copies of csrc/xz_zero.cu with text patches (tools/_clock.py's
patch-and-build, no clocks), one library per form, each held bit-equal to
the normal library first, and times every form in turns (the forms, then
the same forms in reverse order): the device ms per launch (the kernel's
summed durations over its events, torch.profiler over 50 calls after
warm-up), in place on chip_smoke.py's phase-2 layouts (an OS1-64 drive
scan, 64 x 4096; a bench lane, 64 x 2048; a merged multi-LiDAR scan, 128
x 2048; the default configuration, star labels off) and the SP entry on
one SP run's stacked wedges (phase 5's OS1-128 scan, 8 x 128 x 384).
Forms: "kept" (the source as it is: two coalesced 4-byte loads a thread
a field), "tile64" and "tile256" (another TILE), "float4_loads" (16-byte
loads from the first 16-byte boundary, a scalar head and tail around
them), "nan_max_select" (the NaN-propagating maximum as compares and a
select, not max.NaN).  Prints each form's registers (ptxas), the
card's name and power limit and one JSON line; with --sass, each form's
SASS (cuobjdump) lands in DIR with its instruction counts printed.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import _clock  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CALLS = 50
SPAN_OF = """// The float4 form's loads of slots [lo, hi): float4 loads from the first
// 16-byte boundary a (nv of them, at most one a thread), scalar loads for
// the at most 3 + 3 slots around them (threads 0-2 each).
struct Span {
  int lo, a, nv, e, hi;
};

__device__ __forceinline__ Span span_of(const float* src, int lo, int hi) {
  Span sp;
  sp.lo = lo;
  sp.hi = max(hi, lo);
  sp.a = min(lo + (int)((4 - (((unsigned long long)(src + lo) >> 2) & 3))
                        & 3), sp.hi);
  sp.nv = (sp.hi - sp.a) >> 2;
  sp.e = sp.a + 4 * sp.nv;
  return sp;
}

"""
FORMS = {
    "kept": [],
    "tile64": [("constexpr int TILE = 128;", "constexpr int TILE = 64;"),
               ("static_assert(SPAN <= 2 * TILE", "static_assert(SPAN <= 3 * TILE"),
               ("  float v[3][2];", "  float v[3][3];"),
               ("    v[f][1] = lo + TILE + t < hi ? __ldg(src[f] + lo + TILE + t) : 0.0f;",
                "    v[f][1] = lo + TILE + t < hi ? __ldg(src[f] + lo + TILE + t) : 0.0f;\n"
                "    v[f][2] = lo + 2 * TILE + t < hi ? "
                "__ldg(src[f] + lo + 2 * TILE + t) : 0.0f;"),
               ("    if (lo + TILE + t < hi) dst[f][lo + TILE + t] = v[f][1];",
                "    if (lo + TILE + t < hi) dst[f][lo + TILE + t] = v[f][1];\n"
                "    if (lo + 2 * TILE + t < hi) dst[f][lo + 2 * TILE + t] = v[f][2];")],
    "tile256": [("constexpr int TILE = 128;", "constexpr int TILE = 256;")],
    "float4_loads": [
        ("// HALO: the azimuth-sharded rows", SPAN_OF + "// HALO: the azimuth-sharded rows"),
        ("""  float v[3][2];  // slots lo + t and lo + TILE + t of each field
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    v[f][0] = lo + t < hi ? __ldg(src[f] + lo + t) : 0.0f;
    v[f][1] = lo + TILE + t < hi ? __ldg(src[f] + lo + TILE + t) : 0.0f;
  }""",
         """  Span sp[3];
  float4 body[3];
  float head[3], tail[3];
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    sp[f] = span_of(src[f], lo, hi);
    body[f] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    head[f] = tail[f] = 0.0f;
    if (t < sp[f].nv)
      body[f] = __ldg(reinterpret_cast<const float4*>(src[f] + sp[f].a) + t);
    if (t < sp[f].a - lo) head[f] = __ldg(src[f] + lo + t);
    if (t < sp[f].hi - sp[f].e) tail[f] = __ldg(src[f] + sp[f].e + t);
  }"""),
        ("""    if (lo + t < hi) dst[f][lo + t] = v[f][0];
    if (lo + TILE + t < hi) dst[f][lo + TILE + t] = v[f][1];""",
         """    if (t < sp[f].nv) {
      float* d = dst[f] + sp[f].a + 4 * t;
      d[0] = body[f].x;
      d[1] = body[f].y;
      d[2] = body[f].z;
      d[3] = body[f].w;
    }
    if (t < sp[f].a - lo) dst[f][lo + t] = head[f];
    if (t < sp[f].hi - sp[f].e) dst[f][sp[f].e + t] = tail[f];""")],
    "nan_max_select": [
        ('asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));',
         "r = (a != a || b != b) ? __int_as_float(0x7fc00000)"
         " : (a > b ? a : b);")],
}
ENTRIES = ("urf_xz_zero", "urf_xz_zero_halo")


def smoke_module():
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_form(name: str, patches, sass_dir):
    """The form's library (xz_zero.cu patched, the other sources as they
    are, for urf_error_string) and its ptxas register line."""
    from urban_road_filter_torch import _build

    out = _build.BUILD_DIR / "ab_xz_zero" / name
    out.mkdir(parents=True, exist_ok=True)
    src = out / "xz_zero_form.cu"
    src.write_text(_clock.clocked("ab_xz_zero", "xz_zero.cu", patches, None,
                                  None, 0))
    lib_path = out / "libform.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          "-o", str(lib_path), str(src),
                          str(_clock.CSRC / "group_place.cu")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        sys.exit(res.stdout + res.stderr)
    log = (res.stdout + res.stderr).splitlines()
    regs = next((log[k].strip() for i, line in enumerate(log)
                 if "xz_zero_kernel" in line and "Compiling" in line
                 for k in range(i + 1, min(i + 6, len(log)))
                 if "registers" in log[k]), "?")
    lib = ctypes.CDLL(str(lib_path))
    for fn in ENTRIES:
        getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    lib.urf_error_string.argtypes = (ctypes.c_int,)
    lib.urf_error_string.restype = ctypes.c_char_p
    sass = None
    if sass_dir:
        sass = sass_counts(lib_path, Path(sass_dir) / f"xz_zero_{name}.sass")
    return lib, regs, sass


def sass_counts(binary, dump: Path) -> dict | None:
    """Opcode counts of the SASS of every xz_zero kernel in ``binary``
    (cuobjdump -sass), the listing written to ``dump``."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(cuobjdump).exists():
        return None
    text = subprocess.run([cuobjdump, "-sass", str(binary)],
                          capture_output=True, text=True).stdout
    funcs = [f for f in text.split("Function : ")[1:]
             if "xz_zero_kernel" in f.splitlines()[0]]
    dump.parent.mkdir(parents=True, exist_ok=True)
    dump.write_text("".join("Function : " + f for f in funcs))
    out = {}
    for f in funcs:
        ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[0-9T]\s+)?"
                         r"([A-Z][A-Z0-9_.]*)", f)
        hist = {}
        for o in ops:
            hist[o.split(".")[0]] = hist.get(o.split(".")[0], 0) + 1
        out[f.splitlines()[0].strip()[-60:]] = {"all": len(ops), **dict(
            sorted(hist.items(), key=lambda kv: -kv[1])[:14])}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--sass", default=None)
    args = ap.parse_args()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("ab_xz_zero: needs a CUDA device")
    from urban_road_filter_torch import FilterConfig, _build, pad_scan
    from urban_road_filter_torch.ops import geometry
    from urban_road_filter_torch.ops.stencil_kernels import (
        fused_xz_zero_, fused_xz_zero_halo)
    from urban_road_filter_torch.parallel.azimuth_parallel import (
        make_azimuth_pipeline)

    c = smoke_module()
    _build.library()
    dev = torch.device("cuda", 0)
    cfg = FilterConfig(star_shaped_method=False)
    calls = {}
    for name, rings, cap, n, scan in (
            ("os1_64", 64, 4096, 131072, c.os1_64_scan()),
            ("bench_lane", 64, 2048, 131072, c.bench_scans(1)[0]),
            ("multi_lidar", 128, 2048, 262144, c.multi_lidar_scans()[0])):
        pts = torch.from_numpy(pad_scan(scan, n)).to(dev)
        x, y, z, _ = geometry.xyz_of(pts, "rows")
        x, y, z = x.contiguous(), y.contiguous(), z.contiguous()
        valid = geometry.roi_mask_xyz(x, y, z, cfg)
        _, alpha = geometry.vertical_angles(x, y, z)
        angles, _ = geometry.discover_rings(alpha, valid, cfg.interval,
                                            rings=rings)
        ring_id = geometry.assign_rings(alpha, valid, angles, cfg.interval)
        layout, _, _ = geometry.tensorize(x, y, z, ring_id, cap, rings=rings)
        calls[name] = (lambda lay=layout: fused_xz_zero_(lay, cfg),
                       layout.label)
    _, dims, scan, _ = c.sp_deployments()[0]
    probe = {}
    make_azimuth_pipeline(c.WEDGES, cfg, dims, device=dev)(
        torch.from_numpy(pad_scan(scan, dims.max_points)).to(dev),
        probe=probe)
    lay, left, right, prefix, total = probe["halo"]
    calls["sp"] = (lambda: fused_xz_zero_halo(lay, left, right, prefix,
                                              total, cfg), lay.label)
    want = {}
    for name, (fn, table) in calls.items():
        fn()
        want[name] = table.clone()

    libs, info = {}, {}
    for name, patches in FORMS.items():
        libs[name], regs, sass = build_form(name, patches, args.sass)
        info[name] = {"ptxas": regs, "sass": sass}
        print(f"{name}: {regs}; sass {sass}", flush=True)
        for cname, (fn, table) in calls.items():
            table.zero_()
            _clock.on(libs[name], fn)
            assert torch.equal(table, want[cname]), (name, cname)

    def device_ms(fn):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", 0)
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        return us / CALLS / 1e3

    times = {name: {c_: [] for c_ in calls} for name in FORMS}
    order = list(FORMS) + list(reversed(FORMS))
    for name in order:
        for cname, (fn, _) in calls.items():
            times[name][cname].append(_clock.on(
                libs[name], lambda: device_ms(fn)))
    for name in FORMS:
        print(name, {k: [round(v, 6) for v in vs]
                     for k, vs in times[name].items()}, flush=True)
    card = _clock.card()
    print(card)
    out = {"card": card, "forms": info, "device_ms": times}
    print(json.dumps(out))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
