"""One client, closed loop, one scan in flight, through the compiled
single-scan entry ``pipeline.packed_scan_jit``: the host rows are padded
(``pipeline.pad_scan``), handed to the entry, and the packed plane, the
marker table and the flags fetched to host memory.  The pool's scans come
in a permutation drawn from the seed, repeated."""

from __future__ import annotations

import time

import numpy as np

from benchmark.check import unpack_planes
from benchmark.drivers import ClosedLoop


class Driver(ClosedLoop):
    path = "scan"

    def __init__(self, run):
        from urban_road_filter_torch import pipeline

        self.run = run
        self.pipeline = pipeline
        self.order = run.rng.permutation(len(run.pool))

    def lanes(self, i: int) -> list:
        return [int(self.order[i % len(self.order)])]

    def call(self, i: int):
        run, pl = self.run, self.pipeline
        rows = run.pool[self.lanes(i)[0]]
        with run.span("bench::pad"):
            pts = pl.pad_scan(rows, run.dims.max_points)
        with run.span("bench::call"):
            t0 = time.perf_counter()
            out = pl.packed_scan_jit(pts, run.cfg, run.dims, layout="rows",
                                     device=run.device)
            enqueue = time.perf_counter() - t0
        with run.span("bench::fetch"):
            host = [t.cpu() for t in out]
        return host, enqueue

    def warm(self) -> None:
        for i in range(3):
            self.call(i)

    def per_scan(self, host) -> list:
        packed, markers, ok, num_rings, _ = (np.asarray(t) for t in host)
        labels, roi, probably = unpack_planes(packed)
        return [{"labels": labels, "roi": roi, "probably_road": probably,
                 "markers": markers, "ok": bool(ok),
                 "num_rings": int(num_rings)}]
