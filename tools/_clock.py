"""What the phase clocks of tools/clock_*.py share: copies of the port's
CUDA sources with %globaltimer reads (the card's nanosecond clock) patched
in by text, built with the port's nvcc flags into a library of their own,
and the port's wrappers run on it in place of the normal library.

A clocked source gets a device array of ``rows`` x 16 u64 per kernel (one
row per block, written by the patches) and an ``extern "C"`` reader that
copies it to the host.  A patch is an (anchor, replacement) pair; every
anchor must occur, so a tool fails loudly when its source moved on.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "urban_road_filter_torch/csrc"


def declare(name: str, rows: int) -> str:
    """The clock array and the timer read, to put before ``namespace {``."""
    return (f"__device__ unsigned long long {name}[{rows} * 16];\n"
            "static __device__ __forceinline__ unsigned long long gtime() {\n"
            "  unsigned long long t;\n"
            '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
            "  return t;\n}\n")


def record(name: str, rows: int, fields, at: str = "blockIdx.x") -> str:
    """Code that stores ``fields`` in row ``at`` (by default the block's)."""
    body = " ".join(f"d[{i}] = {f};" for i, f in enumerate(fields))
    return (f"  if ({at} < {rows}) {{\n"
            f"    unsigned long long* d = {name} + ({at}) * 16;\n"
            f"    {body}\n  }}\n")


def clocked(tool: str, source: str, patches, reader: str, name: str,
            rows: int) -> str:
    """csrc/<source> with its patches applied and the reader appended (none
    when reader is None)."""
    src = (CSRC / source).read_text()
    for anchor, text in patches:
        if anchor not in src:
            raise SystemExit(f"{tool}: {source} lacks {anchor!r}")
        src = src.replace(anchor, text, 1)
    if reader is None:
        return src
    return src + (f'\nextern "C" int {reader}(unsigned long long* host) {{\n'
                  f"  return (int)cudaMemcpyFromSymbol(host, {name}, "
                  f"sizeof(unsigned long long) * {rows} * 16);\n}}\n")


def build(tool: str, parts, plain=(), entries=()) -> ctypes.CDLL:
    """The clocked library, loaded.  parts: (source, patches, reader, name,
    rows) per clocked source (reader None: patched, not clocked); plain:
    csrc sources linked in as they are; entries: the urf_* functions the wrappers call, given the port's C
    signatures (urf_error_string must be in one of the sources)."""
    from urban_road_filter_torch import _build

    out = _build.BUILD_DIR / tool
    out.mkdir(parents=True, exist_ok=True)
    srcs = []
    for source, patches, reader, name, rows in parts:
        path = out / source.replace(".cu", "_clocked.cu")
        path.write_text(clocked(tool, source, patches, reader, name, rows))
        srcs.append(path)
    srcs += [CSRC / s for s in plain]
    lib_path = out / "libclocked.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                          str(lib_path), *map(str, srcs)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        sys.exit(res.stdout + res.stderr)
    for line in (res.stdout + res.stderr).splitlines():
        if "Used" in line:
            print(line.strip())
    lib = ctypes.CDLL(str(lib_path))
    for fn in entries:
        getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    lib.urf_error_string.argtypes = (ctypes.c_int,)
    lib.urf_error_string.restype = ctypes.c_char_p
    for _, _, reader, _, _ in parts:
        if reader is None:
            continue
        getattr(lib, reader).argtypes = (ctypes.c_void_p,)
        getattr(lib, reader).restype = ctypes.c_int
    return lib


def on(lib, fn):
    """fn() with the port's wrappers launching from lib."""
    from urban_road_filter_torch import _build

    normal = _build.library()
    _build._lib = lib
    try:
        return fn()
    finally:
        _build._lib = normal


def read(lib, reader: str, rows: int) -> np.ndarray:
    """The (rows, 16) int64 clock rows of the last clocked launch."""
    buf = (ctypes.c_ulonglong * (rows * 16))()
    assert getattr(lib, reader)(ctypes.addressof(buf)) == 0
    return np.frombuffer(buf, dtype=np.uint64).reshape(rows, 16).astype(
        np.int64)


def card() -> str:
    """nvidia-smi's name, power limit and maximum SM clock of card 0."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
