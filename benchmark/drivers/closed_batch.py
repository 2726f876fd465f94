"""Offline replay, closed loop, one batch in flight, through the compiled
batch entry ``pipeline.process_batch_jit``: each batch is the host (B, N,
4) float32 rows of ``batch`` scans (made in set-up: the pool's scans, each
``batch / pool`` times, in an order drawn from the seed; ``batches``
distinct orders, used in turn), handed to the entry, and every ScanResult
field fetched to host memory.

The batches and the outputs' host buffers are pinned and made in set-up,
as a replay tool that owns its buffers keeps them: the copies then run at
the link's rate and not at the rate at which the host's memory takes
fresh pages.  The sample keeps whole output sets, so the loop writes into
one of ``sample + 1`` sets, the one that the sample last dropped."""

from __future__ import annotations

import time

import numpy as np

from benchmark.drivers import ClosedLoop


class Driver(ClosedLoop):
    path = "scan"

    def __init__(self, run):
        import torch

        from urban_road_filter_torch import pipeline

        self.run = run
        self.pipeline = pipeline
        self.torch = torch
        self.on_card = run.device != "cpu"
        b = int(run.traffic["batch"])
        pool = len(run.pool)
        if b % pool:
            raise ValueError(f"batch {b} is not a multiple of the pool "
                             f"{pool}")
        self.scans_per_call = b
        lanes = np.repeat(np.arange(pool), b // pool)
        self.orders = [run.rng.permutation(lanes)
                       for _ in range(int(run.traffic["batches"]))]
        n = run.dims.max_points
        padded = [pipeline.pad_scan(rows, n) for rows in run.pool]
        self.batches = []
        for order in self.orders:
            t = torch.empty((b, n, 4), dtype=torch.float32,
                            pin_memory=self.on_card)
            rows = t.numpy()
            for lane, j in enumerate(order):
                rows[lane] = padded[j]
            self.batches.append(t)
        self.free = []
        self.sets = int(run.cell.workload["sample"]) + 1

    def lanes(self, i: int) -> list:
        return [int(j) for j in self.orders[i % len(self.orders)]]

    def _host_set(self, out):
        return out._make(self.torch.empty_like(t, device="cpu",
                                               pin_memory=self.on_card)
                         for t in out)

    def call(self, i: int):
        run = self.run
        batch = self.batches[i % len(self.batches)]
        with run.span("bench::call"):
            t0 = time.perf_counter()
            out = self.pipeline.process_batch_jit(
                batch, run.cfg, run.dims, layout="rows", device=run.device)
            enqueue = time.perf_counter() - t0
        with run.span("bench::fetch"):
            host = self.free.pop() if self.free else self._host_set(out)
            for h, t in zip(host, out):
                h.copy_(t, non_blocking=True)
            if self.on_card:
                self.torch.cuda.current_stream().synchronize()
        return host, enqueue

    def release(self, item) -> None:
        self.free.append(item[1])

    def warm(self) -> None:
        for i in range(3):
            host, _ = self.call(i)
            self.release((i, host))
        while len(self.free) < self.sets:
            self.free.append(self._host_set(host))

    def per_scan(self, host) -> list:
        fields = {k: np.asarray(getattr(host, k)) for k in
                  ("labels", "roi", "probably_road", "markers", "ok",
                   "num_rings")}
        return [{"labels": fields["labels"][b], "roi": fields["roi"][b],
                 "probably_road": fields["probably_road"][b],
                 "markers": fields["markers"][b], "ok": bool(fields["ok"][b]),
                 "num_rings": int(fields["num_rings"][b])}
                for b in range(self.scans_per_call)]
