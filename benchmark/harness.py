"""The benchmark's harness: one run of one cell.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own, found by the name that
``BENCHMARK.json`` gives:

  benchmark/configs/<config>.json     the deployment: sensor, dims, filter
  benchmark/traffic/<traffic>.json    the mix: driver, pool, batch, ...
  benchmark/drivers/<driver>.py       how the mix reaches the program
  benchmark/workloads/<cell>.json     the cell's sample and limits
  benchmark/metrics/<metric>.py       a per-layer metric's reader (or the
                                      file of its name less a dotted
                                      suffix: copy_ms.py reads copy_ms.scan)

A run: set-up (the pool of scans from the seed, the driver, the capture
and warm-up of the cell's one shape), the driver's measured window of
``seconds`` (a sample of the outputs drawn from the seed kept), with
``trace`` a profiled segment after it, then the reference over the
sampled scans and the verdict.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import statistics
import sys
import time
from contextlib import nullcontext
from pathlib import Path

import numpy as np

from benchmark import bounds, check, devtrace, reference, scans

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "urban_road_filter_tpu")


def read_json(*parts) -> dict:
    return json.loads(BENCH.joinpath(*parts).read_text())


def benchmark_file() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def metric_reader(name: str):
    """The ``read(ctx)`` of benchmark/metrics/<name>.py, or where there is
    no such file, of the file named by ``name`` less its last dotted
    suffix, and so on (``kernel_ms.batch`` and ``kernel_ms.scan`` share
    kernel_ms.py)."""
    stem = name
    path = BENCH / "metrics" / f"{stem}.py"
    while not path.is_file() and "." in stem:
        stem = stem.rsplit(".", 1)[0]
        path = BENCH / "metrics" / f"{stem}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver_class(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}").Driver


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """A cell of BENCHMARK.json with its files."""

    def __init__(self, name: str, bench: dict | None = None):
        bench = benchmark_file() if bench is None else bench
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = entries[name]
        self.chips = int(self.entry["chips"])
        self.config = read_json("configs", f"{self.entry['config']}.json")
        self.traffic = read_json("traffic", f"{self.entry['traffic']}.json")
        self.workload = read_json("workloads", f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if applies(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m, name)]


class Run:
    """What a driver sees of a run (drivers/__init__.py)."""

    def __init__(self, cell: Cell, seed: int, device: str, pool=None):
        from urban_road_filter_torch.config import FilterConfig, PipelineDims

        cfg = cell.config
        self.cell = cell
        self.traffic = cell.traffic
        self.device = device
        self.cfg = FilterConfig(**cfg["filter"])
        self.dims = PipelineDims(**cfg["dims"])
        self.rng = np.random.default_rng([int(seed) % (1 << 63), 1])
        self.pool = make_cell_pool(cell, seed) if pool is None else pool
        self.tracing = False

    def span(self, name: str):
        if not self.tracing:
            return nullcontext()
        import torch
        return torch.profiler.record_function(name)


def make_cell_pool(cell: Cell, seed: int) -> list:
    """The cell's pool of scans for ``seed`` (scans.make_pool)."""
    cfg = cell.config
    return scans.make_pool(cell.traffic, cfg["sensor"], int(cfg["firings"]),
                           seed)


class Reservoir:
    """A uniform sample of k items of a stream, drawn from the seed."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item):
        """Keep or drop ``item``; return the item that left the sample
        (``item`` itself where it is not kept, the one it replaced) or
        None."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return None
        j = int(self.rng.integers(0, self.seen))
        if j >= self.k:
            return item
        old, self.items[j] = self.items[j], item
        return old


def quantile(values, q: int) -> float:
    """The q-th percentile (statistics.quantiles, n=100, inclusive)."""
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def reference_outputs(run: Run, indices) -> dict:
    """{pool index: (reference outputs, OracleResult)} of the pool's
    scans ``indices``."""
    settings = reference.filter_settings(run.cell.config["filter"])
    channels = int(run.cell.config["dims"]["rings"])
    out = {}
    for j in sorted(set(indices)):
        ref = reference.run_oracle(run.pool[j], settings, channels=channels)
        out[j] = (check.reference_outputs(ref, run.dims.max_points), ref)
    return out


def imported_forbidden() -> list:
    """Modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", marks: list | None = None,
             pool=None) -> tuple:
    """One run: (result line, check lines).  ``marks``: the caller's part
    of set-up on the host clock, [(part, time at its end)], the first
    ("start", the process's start), from which setup_s is measured;
    ``pool``, the cell's pool for ``seed`` where the caller made it
    already."""
    import torch

    marks = list(marks or [("start", time.perf_counter())])
    on_card = device != "cpu"
    run = Run(cell, seed, device, pool)
    drv = driver_class(cell.traffic["driver"])(run)
    marks.append(("driver", time.perf_counter()))
    drv.warm()
    if on_card:
        torch.cuda.synchronize()
    marks.append(("warm-up", time.perf_counter()))
    sample = Reservoir(int(cell.workload["sample"]), run.rng)
    # Set-up's objects out of the collector's way: the window's
    # collections then walk only what the window allocates.
    gc.collect()
    gc.freeze()
    marks.append(("collector", time.perf_counter()))
    setup_s = marks[-1][1] - marks[0][1]
    setup_parts = {name: t - marks[k][1]
                   for k, (name, t) in enumerate(marks[1:])}
    win = drv.window(seconds, sample)
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    tr = None
    if trace and on_card:
        def traced_call(i):
            host, _ = drv.call(i)
            drv.release((i, host))

        run.tracing = True
        tr = devtrace.record(traced_call, int(cell.traffic["trace_calls"]),
                             drv.scans_per_call)
        run.tracing = False

    # The sampled calls' outputs, scan by scan, with the pool index of
    # each; then the program's state is freed before the reference runs.
    kept = [(lane, j) for i, host in sample.items
            for lane, j in zip(drv.per_scan(host), drv.lanes(i))]
    path, per_call_scans = drv.path, drv.scans_per_call
    del drv, sample
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    want_idx = [j for _, j in kept]
    if tr is not None:
        want_idx += list(range(len(run.pool)))
    refs = reference_outputs(run, want_idx)
    per_scan = [check.compare(lane, refs[j][0]) for lane, j in kept]
    limits = cell.workload["limits"]
    correct, failed, checks = check.verdict(per_scan, limits)

    metrics = {}
    if not trace:
        values = {"setup_s": setup_s,
                  "scans_per_s": win.scans / win.seconds}
        if len(win.latency_s) > 1:
            values["scan_ms_p50"] = quantile(win.latency_s, 50) * 1e3
            values["scan_ms_p95"] = quantile(win.latency_s, 95) * 1e3
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        ctx = Context(cell, path, per_call_scans, tr, win.enqueue_s, refs)
        for m in cell.per_layer:
            v = metric_reader(m["name"])(ctx) if tr is not None else None
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    line = {"correct": correct, "attempted": win.scans, "failed": failed,
            "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        line["breakdown"] = {"device_ops": tr.top_ops(),
                             "idle_gaps": tr.idle_gaps()}
    # Set-up by part (the kernel library's part is the nvcc build on a
    # checkout's first run): keys that the result's reader ignores.
    line["build_s"] = setup_parts.get("kernel library", 0.0)
    line["setup_parts"] = setup_parts
    lines = ["set-up by part (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in setup_parts.items())]
    line["checks"] = checks
    lines += [f"check {k}: {v['value']} (limit {v['limit']})"
              for k, v in checks.items()]
    lines.append(f"check scans compared: {len(per_scan)}, failed {failed}, "
                 f"calls in the window {win.calls}")
    return line, lines


class Context:
    """What a per-layer metric's reader sees: the traced segment
    (``trace``, a devtrace.Trace: device rows by kind, busy and window
    seconds, the scans it completed), the window's host seconds of each
    entry call until it returned (``enqueue_s``), the scans a call
    completes, and the least bytes a scan's kernels move on the driver's
    path (``bytes_per_scan``: the mean over the pool's scans, from the
    reference's counts)."""

    def __init__(self, cell, path, scans_per_call, trace, enqueue_s, refs):
        self.trace = trace
        self.enqueue_s = enqueue_s
        self.scans_per_call = scans_per_call
        star = bool(cell.config["filter"]["star_shaped_method"])
        per = [bounds.path_bytes(bounds.scan_counts(ref, cell.config["dims"]),
                                 path, star)
               for _, ref in refs.values()]
        self.bytes_per_scan = float(np.mean(per)) if per else None
        self.hbm_bytes_s = bounds.HBM_BYTES_S

    def device_ms_per_scan(self, *kinds):
        if self.trace is None or not self.trace.scans:
            return None
        s = self.trace.seconds(*kinds)
        return s / self.trace.scans * 1e3
