"""ctypes loader for the native host runtime (runtime/csrc/urf_native.cpp).

Builds the shared library with g++ on first use (cached in this
package's runtime/_build/, never shared with the JAX package's; rebuilt
when the source changes) and exposes:

  * read_pcd_native(path)      — fast binary/ascii PCD parse -> (N, 4) f32
  * stage_batch_native(scans)  — multithreaded pad/pack to (B, cap, 4) f32

Both return None / raise cleanly when the toolchain is unavailable, so the
pure-Python paths in io.pcd / pipeline.pad_scan remain the fallback.

A copy of the JAX package's runtime/native.py; ``get_lib() is None`` says
that the fallback is in use (chip_smoke.py asserts it is not).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "csrc", "urf_native.cpp")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build_and_load() -> Optional[ctypes.CDLL]:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    cache_dir = os.path.join(_HERE, "_build")
    os.makedirs(cache_dir, exist_ok=True)
    so_path = os.path.join(cache_dir, f"liburf_native_{tag}.so")
    if not os.path.exists(so_path):
        # A temporary name of this process's own: test workers may build
        # side by side.
        tmp = f"{so_path}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
               _SRC, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (subprocess.SubprocessError, FileNotFoundError) as e:
            raise RuntimeError(f"native build failed: {e}") from e
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(so_path)
    lib.urf_read_pcd.restype = ctypes.c_long
    lib.urf_read_pcd.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_float), ctypes.c_long]
    lib.urf_stage_batch.restype = None
    lib.urf_stage_batch.argtypes = [
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_long), ctypes.c_long,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long]
    lib.urf_lzf_decompress.restype = ctypes.c_long
    lib.urf_lzf_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_long]
    lib.urf_native_abi_version.restype = ctypes.c_long
    assert lib.urf_native_abi_version() == 2
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, or None if it cannot be built here."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOCK:
        if _LIB is None and not _TRIED:
            try:
                _LIB = _build_and_load()
            except RuntimeError:
                _LIB = None
            _TRIED = True
    return _LIB


def read_pcd_native(path: str, max_points: int = 1 << 22) -> Optional[np.ndarray]:
    """Parse a PCD file natively.  None if the native lib is unavailable;
    raises ValueError on parse errors (caller may fall back)."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((max_points, 4), np.float32)
    n = lib.urf_read_pcd(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_points)
    if n < 0:
        raise ValueError(f"native PCD parse failed ({n}) for {path}")
    return out[:n].copy()


def lzf_decompress_native(data: bytes, expected_size: int) -> Optional[bytes]:
    """Native LZF decode (PCL binary_compressed payloads).  None when the
    native lib is unavailable; raises ValueError on malformed streams."""
    lib = get_lib()
    if lib is None:
        return None
    out = (ctypes.c_ubyte * expected_size)()
    n = lib.urf_lzf_decompress(data, len(data), out, expected_size)
    if n != expected_size:
        raise ValueError(f"native LZF decode failed ({n})")
    return bytes(out)


def stage_batch_native(scans: Sequence[np.ndarray], cap: int) -> Optional[np.ndarray]:
    """Pack scans into a (B, cap, 4) padded float32 batch, multithreaded."""
    lib = get_lib()
    if lib is None:
        return None
    b = len(scans)
    prepared = []
    for s in scans:
        a = np.zeros((len(s), 4), np.float32)
        a[:, :min(4, s.shape[1])] = s[:, :4]
        prepared.append(np.ascontiguousarray(a))
    out = np.empty((b, cap, 4), np.float32)
    ptrs = (ctypes.POINTER(ctypes.c_float) * b)(
        *[p.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for p in prepared])
    lens = (ctypes.c_long * b)(*[len(p) for p in prepared])
    lib.urf_stage_batch(ptrs, lens, b,
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap)
    return out
