"""Each per-layer metric's reader on a small synthetic trace."""

from __future__ import annotations

import json

import pytest

from benchmark import devtrace, harness

BENCH = harness.benchmark_file()

OWN = "void (anonymous namespace)::labeled_kernel<true>(float const*)"
GLUE = "void at::native::vectorized_elementwise_kernel<4>(int)"
# (start us, end us, name, kind): 10 scans' worth of rows in a 1000 us
# window: 100 us of copies, 200 us of glue (memset included), 50 us of the
# port's kernels, overlapping nothing; busy 350 us.
DEVICE = [(0, 60, "Memcpy HtoD (Pageable -> Device)", "memcpy"),
          (100, 140, "Memcpy DtoH (Device -> Pageable)", "memcpy"),
          (200, 390, GLUE, "glue"), (390, 400, "Memset (Device)", "memset"),
          (500, 550, OWN, "own")]
HOST = [(0, 1000, "bench::call"), (400, 500, "cudaGraphLaunch"),
        (550, 1000, "bench::fetch")]


class Ctx:
    def __init__(self, trace, enqueue=(0.001, 0.003), per_call=1,
                 bytes_per_scan=3.35e6):
        self.trace = trace
        self.enqueue_s = list(enqueue)
        self.scans_per_call = per_call
        self.bytes_per_scan = bytes_per_scan
        self.hbm_bytes_s = 3.35e12

    device_ms_per_scan = harness.Context.device_ms_per_scan


EXPECTED = {"copy_ms": 0.01, "glue_ms": 0.02, "kernel_ms": 0.005,
            "enqueue_ms": 2.0, "device_idle_pct": 65.0,
            # 3.35e6 B at 3.35e12 B/s = 1 us a scan, over 5 us of kernels
            "kernels_roofline": 20.0}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_reader_on_synthetic_trace(metric):
    tr = devtrace.Trace(DEVICE, HOST, window_s=1e-3, scans=10)
    got = harness.metric_reader(metric)(Ctx(tr))
    assert got == pytest.approx(EXPECTED[metric.split(".")[0]], rel=1e-9)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]
                                    if m["source"] == "device_trace"])
def test_reader_with_nothing_to_read(metric):
    assert harness.metric_reader(metric)(Ctx(None)) is None
    empty = devtrace.Trace([], [], window_s=1e-3, scans=10)
    assert harness.metric_reader(metric)(Ctx(empty)) is None


def test_kinds_and_gaps():
    tr = devtrace.Trace(DEVICE, HOST, window_s=1e-3, scans=10)
    assert devtrace.kind_of(OWN) == "own"
    assert devtrace.kind_of(GLUE) == "glue"
    assert devtrace.kind_of("void place_kernel(PlaceArgs)") == "own"
    assert devtrace.kind_of("void my_place_kernel(int)") == "glue"
    assert tr.busy_s() == pytest.approx(350e-6)
    gaps = dict(tr.idle_gaps())
    assert gaps["bench::call"] == pytest.approx((40 + 60) * 1e-6)
    assert gaps["cudaGraphLaunch"] == pytest.approx(100e-6)
    assert [n for n, _ in tr.top_ops()][0] == GLUE
    line = json.dumps({"device_ops": tr.top_ops(), "idle_gaps":
                       tr.idle_gaps()})
    assert len(json.loads(line)["device_ops"]) <= 10


def test_every_kernel_of_the_port_is_listed():
    """kernels.json names each __global__ of the port's CUDA sources."""
    import re

    names = set()
    for src in (harness.ROOT / "urban_road_filter_torch" / "csrc").glob(
            "*.cu"):
        text = src.read_text()
        names |= set(re.findall(r"__global__.{0,200}?\b(\w+_kernel)\s*\(",
                                text, re.S))
    assert names == set(devtrace.own_kernels())
