"""Build, load and launch the port's CUDA kernels; count their launches.

The sources in ``csrc/*.cu`` are compiled with ``nvcc`` for ``sm_90a``, one
``nvcc`` per source, all started together, and linked into one shared
library with a plain C interface, at first use, under ``_build/`` (named by
a hash of the sources and flags, so an edited source is rebuilt).  The library is loaded with ``ctypes``: pointers and the
stream travel as ``c_void_p``.  Nothing here runs when the package is
imported, so the CPU tests import every module without ``nvcc``.

Every kernel wrapper in ``ops/`` counts one launch here each time it
launches its kernel, and nowhere else; ``launch_counts`` shows whether a
run really went through the kernels, and ``device_ops`` how many device
ops one call enqueues.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC")

# Launch-counter name -> (its CUDA source, the TPU kernel it replaces).
KERNELS = {
    "ingest_prep": ("urban_road_filter_torch/csrc/ingest.cu",
                    "urban_road_filter_tpu/ops/ingest_scan.py:159"),
    "discover_rings": ("urban_road_filter_torch/csrc/ingest.cu",
                       "urban_road_filter_tpu/ops/ingest_scan.py:320"),
    "assign_rings": ("urban_road_filter_torch/csrc/ingest.cu",
                     "urban_road_filter_tpu/ops/ingest_scan.py:421"),
    "star_walk": ("urban_road_filter_torch/csrc/star.cu",
                  "urban_road_filter_tpu/ops/star_scan.py:225"),
    "group_rank": ("urban_road_filter_torch/csrc/group_place.cu",
                   "urban_road_filter_tpu/ops/rank.py:112"),
    "group_place": ("urban_road_filter_torch/csrc/group_place.cu",
                    "urban_road_filter_tpu/ops/place.py:258"),
    "xz_zero": ("urban_road_filter_torch/csrc/xz_zero.cu",
                "urban_road_filter_tpu/ops/pallas_kernels.py:106"),
    "flood_blocked": ("urban_road_filter_torch/csrc/flood.cu",
                      "urban_road_filter_tpu/ops/flood_scan.py:142"),
    "flood_labeled": ("urban_road_filter_torch/csrc/flood.cu",
                      "urban_road_filter_tpu/ops/flood_scan.py:418"),
    "marker_points": ("urban_road_filter_torch/csrc/markers.cu",
                      "urban_road_filter_tpu/ops/marker_scan.py:343"),
    "gather_pack": ("urban_road_filter_torch/csrc/gather_pack.cu",
                    "urban_road_filter_tpu/ops/gather.py:126"),
    "flood_road": ("urban_road_filter_torch/csrc/flood.cu",
                   "urban_road_filter_tpu/ops/flood_scan.py:470"),
    "marker_first_nonroad": ("urban_road_filter_torch/csrc/markers.cu",
                             "urban_road_filter_tpu/ops/marker_scan.py:187"),
    "marker_state": ("urban_road_filter_torch/csrc/markers.cu",
                     "urban_road_filter_tpu/ops/marker_scan.py:139"),
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "urf_ingest_prep": (_P, _P, _P, _I, _I, _L, _L, _F, _F, _F, _F, _F, _F,
                        _F, _I, _P, _P, _P, _P, _P, _P),
    "urf_discover_rings": (_P, _P, _I, _I, _F, _I, _P, _P, _P, _P, _P),
    "urf_assign_rings": (_P, _P, _P, _I, _I, _I, _F, _P, _P, _P),
    "urf_star_search": (_P, _P, _P, _L, _I, _F, _F, _F, _I, _P, _P, _P),
    "urf_group_rank": (_P, _I, _I, _P, _P, _P, _P),
    "urf_group_place": (_P, _P, _P, _I, _I, _P, _P, _P, _L, _L, _L, _I, _I,
                        _P, _P, _P),
    "urf_xz_zero": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F,
                    _F, _P),
    "urf_xz_zero_halo": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P),
    "urf_flood_blocked": (_P, _P, _P, _P, _I, _I, _I, _F, _P, _P, _P),
    "urf_flood_labeled": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P, _P, _P),
    "urf_marker_points": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _I,
                          _P, _P),
    "urf_gather_pack": (_P, _P, _I, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P,
                        _P, _P),
    "urf_flood_road": (_P, _P, _P, _P, _P, _I, _I, _F, _P, _P),
    "urf_marker_first_nonroad": (_P, _P, _P, _P, _I, _I, _P, _P),
    "urf_marker_state": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I,
                         _P, _I, _P, _P),
}

# Kernels whose blocks take tickets from per-device counters that run on
# across launches (K1 csrc/ingest.cu, K9 csrc/flood.cu, K13
# csrc/markers.cu): two launches of one of them in flight at once, on two
# streams, would break its results.
TICKETED = ("ingest_prep", "flood_labeled", "marker_first_nonroad")

# True while a torch profiler records (one C call: the launch path's only
# cost without a profiler).
_profiling = torch._C._autograd._profiler_enabled

_launches = dict.fromkeys(KERNELS, 0)
_last_stream: dict = {}  # (ticketed kernel, device) -> its latest stream
_lib = None


def launch_counts() -> dict:
    """Launches of each kernel since the last reset."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (take the plain PyTorch twin), False for a CUDA
    tensor (launch the kernel); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def build() -> Path:
    """Compile csrc/*.cu into _build/ unless that exact build exists: one
    nvcc process per source, run side by side, then one link.  Returns the
    library's path; nvcc's register report lands beside it as
    ``<library>.log``."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.read_bytes())
    out = BUILD_DIR / f"liburf_kernels_{h.hexdigest()[:16]}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f".{src.stem}.{tag}.o" for src in sources]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    log = []
    try:
        for cmd, proc in zip(cmds, procs):
            text = proc.communicate()[0]
            log.append(text)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{text}")
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
               *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}): "
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("".join(log) + res.stdout + res.stderr)
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for fn, args in _SIGNATURES.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        lib.urf_error_string.argtypes = (ctypes.c_int,)
        lib.urf_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(t: torch.Tensor, what: str, dtype: torch.dtype, shape=None,
          device=None, contiguous: bool = True) -> None:
    """Raise unless ``t`` is a CUDA tensor of this dtype/shape (on
    ``device`` when given), contiguous unless ``contiguous`` is False."""
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{what}: expected a CUDA tensor on "
                         f"{device or 'cuda'}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")


def check_marker_dims(rings: int, p: int) -> None:
    """The marker key (ops/markers.py) packs the ring into 15 bits and the
    slot into 16."""
    if rings >= 1 << 15 or p > 1 << 16:
        raise ValueError(f"marker keys need rings < 2^15 and capacity <= "
                         f"2^16, got ({rings}, {p})")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _one_stream(kernel: str, device: torch.device, stream) -> None:
    """Raise if a ticketed kernel is issued on another stream than its
    latest launch while that stream may still be running it."""
    key = (kernel, device.index)
    last = _last_stream.get(key)
    if (last is not None and last.cuda_stream != stream.cuda_stream
            and not torch.cuda.is_current_stream_capturing()
            and not last.query()):
        raise RuntimeError(
            f"{kernel}: its launches take tickets from per-device counters, "
            f"so it must not run on two streams at once; the stream of its "
            f"latest launch is still busy (synchronize it first)")
    _last_stream[key] = stream


def launch(kernel: str, fn: str, device: torch.device, *args) -> None:
    """Call C entry ``fn`` on ``device``'s current stream, raise on a CUDA
    error, and count one launch of ``kernel``.  A TICKETED kernel raises
    instead when its latest launch's stream is another one and still
    busy.  While a profiler runs, the call sits in a ``urf::k::<kernel>``
    range inside the caller's ``urf::<stage>`` range: the profiler links
    a ctypes launch only to the innermost range, on the device timeline
    (utils.profiling.stage_device_time)."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        if kernel in TICKETED:
            _one_stream(kernel, device, stream)
        entry = getattr(lib, fn)
        handle = ctypes.c_void_p(stream.cuda_stream)
        if _profiling():
            with torch.profiler.record_function(f"urf::k::{kernel}"):
                err = entry(*args, handle)
        else:
            err = entry(*args, handle)
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err}: "
                           f"{lib.urf_error_string(err).decode()}")
    _launches[kernel] += 1


def device_ops(fn) -> int:
    """Device ops (kernels, memsets, copies) that one call of fn enqueues,
    counted exactly: fn is called once, then captured once into a CUDA
    graph (which runs nothing), whose kernel, memcpy and memset nodes are
    counted through libcuda."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kind = ctypes.c_int(0)
    ops = 0  # CU_GRAPH_NODE_TYPE_KERNEL, _MEMCPY and _MEMSET are 0, 1, 2
    for node in nodes:
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                 ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        ops += kind.value in (0, 1, 2)
    graph.reset()
    return ops
