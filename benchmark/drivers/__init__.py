"""Traffic drivers: how a cell's scans reach the program.

A traffic file (``benchmark/traffic/<name>.json``) names its driver by
module name here.  Each module defines ``Driver(run)`` with:

  path            the kernel path of benchmark/bounds.py it drives
  scans_per_call  scans one call completes
  warm()          build and capture the cell's one shape, then replay it
  window(seconds, sample)
                  the measured window: a Window, with ``sample`` (a
                  harness.Reservoir) offered each call's (i, host outputs)
  call(i)         one unit from host rows to every output in host memory:
                  (host outputs, host seconds of the entry call until it
                  returned, before any synchronisation); the traced segment
                  makes these calls after the window
  release(item)   hand back an (i, host outputs) item that the sample
                  dropped, so its host buffers can be written again
  lanes(i)        the pool index of each scan of call i
  per_scan(out)   call's host outputs as one dict per scan: labels, roi,
                  probably_road (per padded point), markers (361, 6), ok,
                  num_rings

``run`` (harness.Run) holds the pool, the program's configuration and
dims, the traffic's parameters, the cell's files, the seed's generator,
the device and ``span(name)``, a profiler range while a trace records
(free otherwise).  A closed-loop driver takes its window from ClosedLoop;
a driver with another window (an open loop, timed from when each scan was
due) writes its own and returns the same Window.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class Window:
    """What a measured window did: its host seconds (from its start to the
    end of its last call), the calls and scans it completed, each scan's
    latency in seconds (empty where a call completes several), and each
    call's host seconds in the entry until it returned."""

    seconds: float
    calls: int
    scans: int
    latency_s: list = field(default_factory=list)
    enqueue_s: list = field(default_factory=list)


class ClosedLoop:
    """The window of a closed loop: one call in flight, back to back, every
    call timed on the host clock from handing the rows over to every
    output in host memory."""

    scans_per_call = 1

    def release(self, item) -> None:
        pass

    def window(self, seconds: float, sample) -> Window:
        latency, enqueue = [], []
        i = 0
        t0 = time.perf_counter()
        while True:
            c0 = time.perf_counter()
            host, enq = self.call(i)
            c1 = time.perf_counter()
            latency.append(c1 - c0)
            enqueue.append(enq)
            dropped = sample.offer((i, host))
            if dropped is not None:
                self.release(dropped)
            i += 1
            if c1 - t0 >= seconds:
                break
        return Window(c1 - t0, i, i * self.scans_per_call,
                      latency if self.scans_per_call == 1 else [], enqueue)
