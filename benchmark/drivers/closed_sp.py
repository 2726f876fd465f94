"""One client, closed loop, one scan in flight, through the compiled SP
run of ``parallel.azimuth_parallel.make_azimuth_pipeline`` (all wedges on
one card; ``wedges`` in the traffic file): the host rows are padded
(``pipeline.pad_scan``), handed to the run, and every ScanResult field
fetched to host memory.  The pool's scans come in a permutation drawn from
the seed, repeated; they are azimuth-sorted, as the SP path assumes."""

from __future__ import annotations

import time

import numpy as np

from benchmark.drivers import ClosedLoop


class Driver(ClosedLoop):
    path = "sp"

    def __init__(self, run):
        from urban_road_filter_torch import pipeline
        from urban_road_filter_torch.parallel.azimuth_parallel import (
            make_azimuth_pipeline)

        self.run = run
        self.pipeline = pipeline
        self.sp = make_azimuth_pipeline(int(run.traffic["wedges"]), run.cfg,
                                        run.dims, device=run.device)
        self.order = run.rng.permutation(len(run.pool))

    def lanes(self, i: int) -> list:
        return [int(self.order[i % len(self.order)])]

    def call(self, i: int):
        run = self.run
        rows = run.pool[self.lanes(i)[0]]
        with run.span("bench::pad"):
            pts = self.pipeline.pad_scan(rows, run.dims.max_points)
        with run.span("bench::call"):
            t0 = time.perf_counter()
            out = self.sp(pts)
            enqueue = time.perf_counter() - t0
        with run.span("bench::fetch"):
            host = out._make(t.cpu() for t in out)
        return host, enqueue

    def warm(self) -> None:
        for i in range(3):
            self.call(i)

    def per_scan(self, host) -> list:
        return [{"labels": np.asarray(host.labels),
                 "roi": np.asarray(host.roi),
                 "probably_road": np.asarray(host.probably_road),
                 "markers": np.asarray(host.markers),
                 "ok": bool(host.ok), "num_rings": int(host.num_rings)}]
