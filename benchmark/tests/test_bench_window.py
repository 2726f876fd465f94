"""The drivers' closed-loop window and the sample it fills: every call
offered once, each dropped item handed back to the driver, so a driver
that writes its outputs into host buffers of its own needs no more than
the sample's size and one."""

from __future__ import annotations

import numpy as np

from benchmark import harness
from benchmark.drivers import ClosedLoop


def test_reservoir_returns_each_item_it_drops_once():
    sample = harness.Reservoir(3, np.random.default_rng(7))
    dropped = [sample.offer(i) for i in range(50)]
    left = [d for d in dropped if d is not None]
    assert len(sample.items) == 3
    assert sorted(left + sample.items) == list(range(50))
    assert dropped[:3] == [None, None, None]


class Buffers(ClosedLoop):
    """A driver whose calls write into host buffers it owns."""

    def __init__(self):
        self.free, self.made, self.busy = [], 0, set()

    def call(self, i):
        if not self.free:
            self.made += 1
            self.free.append(object())
        host = self.free.pop()
        assert id(host) not in self.busy
        self.busy.add(id(host))
        return host, 0.0

    def release(self, item):
        self.busy.discard(id(item[1]))
        self.free.append(item[1])


def test_closed_loop_hands_back_what_the_sample_drops():
    drv = Buffers()
    sample = harness.Reservoir(2, np.random.default_rng(3))
    win = drv.window(0.05, sample)
    assert win.calls == win.scans == len(win.latency_s) > 10
    assert len(win.enqueue_s) == win.calls
    assert sample.seen == win.calls and len(sample.items) == 2
    assert drv.made <= 3
    assert drv.busy == {id(h) for _, h in sample.items}


def test_batch_window_reports_no_scan_latency():
    drv = Buffers()
    drv.scans_per_call = 4
    win = drv.window(0.01, harness.Reservoir(1, np.random.default_rng(0)))
    assert win.scans == 4 * win.calls and win.latency_s == []
