"""Streaming replay harness on the card: the port's L0 host runtime.

A port of urban_road_filter_tpu/io/replay.py (its own code, not a subclass:
the port imports nothing of the JAX package).  It replaces the reference's
ROS node + rosbag flow: a scan source (NPZ sequence, PCD directory, rosbag
or synthetic generator) is replayed at a configurable rate through the
port's pipeline, producing the same five outputs per scan (road / curb /
roi / road_probably clouds + marker strips) as Python structures, with:

  * queue-depth-1 drop semantics (lidar_segmentation.cpp:53) or lossless
    mode; a dropped scan is consumed raw and never staged;
  * staging that overlaps the device: scan t+1 is padded into a pinned
    host buffer and copied host to device on a side stream while the card
    works on scan t; ``pipeline_depth`` >= 2 keeps that many scans in
    flight;
  * every published output fetched in one synchronisation (non-blocking
    device-to-host copies into pinned buffers, then one event);
  * per-scan structured stats + stream latency percentiles (utils.metrics);
  * checkpoint/resume: stream offset + config hash persisted as JSON;
  * per-scan fault isolation, and config hot-swap between scans.

The hooks that differ from the JAX harness: ``_process`` calls
``pipeline.packed_scan(..., layout="planar")``, or with ``azimuth_shard``
> 1 the run of ``parallel.azimuth_parallel.make_azimuth_pipeline`` (all
wedges on the one card), built once; ``_to_device`` stages as above;
``_fetch_outputs`` tells packed_scan's tuple from a ScanResult by its
concrete type (the JAX harness tests ``isinstance(out, tuple)``, which a
ScanResult NamedTuple also passes, so its SP mode cannot unpack a scan).
Checked mode (``checked=True``, ``--checked``) runs each scan through
utils.checked.process_scan_checked; its device error word is one more
field of the scan's single synchronisation, and a broken index contract
raises there, so the scan is recorded as an error.  Kernels are launched
from the one compute stream only (K1, K9 and K13 count their blocks with
per-device tickets, _build.TICKETED); the side stream only copies.

Run as a CLI:  python -m urban_road_filter_torch.io.replay --scene two_curbs
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import deque
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from urban_road_filter_torch.config import FilterConfig, PipelineDims
from urban_road_filter_torch.constants import LABEL_CURB, LABEL_ROAD
from urban_road_filter_torch.pipeline import (
    ScanResult, pad_scan_planar, packed_scan, target_device, unpack_planes)
from urban_road_filter_torch.postprocess import (
    MarkerTracker, build_line_strips, smooth_marker_flags)
from urban_road_filter_torch.utils.checked import (
    CheckError, process_scan_checked)
from urban_road_filter_torch.utils.metrics import ScanStats, StreamMetrics

__all__ = ["ScanOutputs", "ReplayHarness", "scene_source", "npz_source",
           "pcd_dir_source", "bag_source"]


@dataclasses.dataclass
class ScanOutputs:
    """The reference's five published topics, as arrays (SURVEY.md section 0)."""

    seq: int
    ok: bool
    road: np.ndarray  # (n_road, 4) points labeled road
    curb: np.ndarray  # (n_curb, 4)
    roi: np.ndarray  # (n_roi, 4) all in-ROI points
    road_probably: np.ndarray  # ring #10 dump
    marker_strips: list  # postprocess.LineStrip
    stats: ScanStats


def scene_source(scene: str = "two_curbs", n_scans: int = 100,
                 n_rings: int = 64, n_azimuth: int = 1024) -> Iterator[np.ndarray]:
    """Synthetic endless drive: the scene jitters a little per scan."""
    from urban_road_filter_torch.io.synthetic import SCENES, make_scan

    spec = SCENES[scene]()
    for i in range(n_scans):
        yield make_scan(spec, n_rings=n_rings, n_azimuth=n_azimuth, seed=i)


def npz_source(path: str) -> Iterator[np.ndarray]:
    from urban_road_filter_torch.io.pcd import read_scan_sequence

    yield from read_scan_sequence(path)


def pcd_dir_source(path: str) -> Iterator[np.ndarray]:
    from urban_road_filter_torch.io.pcd import read_pcd

    for name in sorted(os.listdir(path)):
        if name.endswith(".pcd"):
            yield read_pcd(os.path.join(path, name))


def bag_source(path: str, topic: Optional[str] = None) -> Iterator[np.ndarray]:
    """Recorded rosbag PointCloud2 stream (the reference's own validation
    flow replays a campus rosbag, reference README.md:36-46)."""
    from urban_road_filter_torch.io.rosbag import read_bag

    yield from read_bag(path, topic=topic)


class ReplayHarness:
    def __init__(self, cfg: Optional[FilterConfig] = None,
                 dims: Optional[PipelineDims] = None,
                 rate_hz: float = 0.0,
                 drop_when_behind: bool = True,
                 checkpoint_path: Optional[str] = None,
                 on_scan: Optional[Callable[[ScanOutputs], None]] = None,
                 azimuth_shard: int = 0,
                 checked: bool = False,
                 pipeline_depth: int = 1,
                 device=None):
        # device=None is the card; without one this raises, as the
        # pipeline's entry points do.  "cpu" runs the plain twins.
        self.device = target_device(device)
        self.cfg = cfg or FilterConfig()
        self.dims = dims or PipelineDims()
        self.rate_hz = rate_hz
        self.drop_when_behind = drop_when_behind
        self.checkpoint_path = checkpoint_path
        self.on_scan = on_scan
        # pipeline_depth > 1: keep that many scans in flight (dispatch scan
        # t+1 before fetching scan t's outputs), so host work and the
        # transfers overlap the device step.  Depth 1 is the reference's
        # strict queue-1 serial semantics (lidar_segmentation.cpp:53);
        # outputs, ordering and per-scan isolation are identical at any
        # depth.  One semantic difference: dropped positions are
        # checkpointed at the NEXT delivery instead of immediately, so a
        # crash inside a drop burst re-consumes (and processes) those scans
        # on resume: at-least-once for drops, never a lost scan.
        self.pipeline_depth = max(1, int(pipeline_depth))
        # azimuth_shard > 1: run each scan cut into that many azimuth
        # wedges (the 128-beam multi-LiDAR SP mode), all on this device;
        # the same five-topic ScanOutputs.
        self.azimuth_shard = int(azimuth_shard)
        # checked: index contracts checked on the device (utils/checked.py),
        # a broken one raises instead of being masked silently; the SP
        # path takes precedence, as in the JAX harness.
        self.checked = bool(checked)
        self._sp_run = None
        self.metrics = StreamMetrics()
        self.tracker = MarkerTracker()
        self._seq = 0
        # CUDA staging: one pinned (3, N) buffer per scan that can be in
        # flight or staged (depth + 1), each with the event of its latest
        # copy, and the side stream that only copies.
        self._pinned: list = []
        self._copied: list = []
        self._slot = 0
        self._copy_stream = None

    def _process(self, dev_scan):
        if self.device.type == "cuda":
            # The scan was copied on the side stream: order the compute
            # stream after it, and tell the allocator the tensor is used
            # here.
            stream = torch.cuda.current_stream(self.device)
            stream.wait_stream(self._copy_stream)
            dev_scan.record_stream(stream)
        if self.azimuth_shard > 1:
            if self._sp_run is None:
                from urban_road_filter_torch.parallel.azimuth_parallel import (
                    make_azimuth_pipeline)

                self._sp_run = make_azimuth_pipeline(
                    self.azimuth_shard, self.cfg, self.dims,
                    device=self.device)
            return self._sp_run(dev_scan, self.cfg, layout="planar")
        if self.checked:
            return process_scan_checked(dev_scan, self.cfg, self.dims,
                                        throw=False, layout="planar",
                                        device=self.device)
        # Default path: the packed wire format (labels/roi/probably_road on
        # ONE uint8 plane), unpacked by _fetch_outputs.
        return packed_scan(dev_scan, self.cfg, self.dims, layout="planar",
                           device=self.device)

    # ---- checkpoint / resume ----
    def _save_checkpoint(self) -> None:
        if not self.checkpoint_path:
            return
        state = {"seq": self._seq, "config_hash": self.cfg.config_hash(),
                 "ghostcount": self.tracker.ghostcount}
        tmp = self.checkpoint_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, self.checkpoint_path)

    def _load_checkpoint(self) -> int:
        if not (self.checkpoint_path and os.path.exists(self.checkpoint_path)):
            return 0
        with open(self.checkpoint_path) as f:
            state = json.load(f)
        if state.get("config_hash") != self.cfg.config_hash():
            return 0  # config changed: restart the stream
        self.tracker.ghostcount = state.get("ghostcount", 0)
        return int(state.get("seq", 0))

    # ---- main loop ----
    def _to_device(self, raw: np.ndarray) -> torch.Tensor:
        """The scan as (3, max_points) planes on the device (pad_scan_planar;
        the intensity column no device stage reads is not sent).  On CUDA:
        padded into the next pinned buffer, once that buffer's previous
        copy has completed, then copied without blocking on the side
        stream."""
        n = self.dims.max_points
        if self.device.type != "cuda":
            return torch.from_numpy(pad_scan_planar(raw, n))
        if not self._pinned:
            self._copy_stream = torch.cuda.Stream(self.device)
            self._pinned = [torch.empty((3, n), dtype=torch.float32,
                                        pin_memory=True)
                            for _ in range(self.pipeline_depth + 1)]
            self._copied = [None] * len(self._pinned)
        k = self._slot
        if self._copied[k] is not None:
            self._copied[k].synchronize()  # its last copy has left it
        host = self._pinned[k]
        pad_scan_planar(raw, n, out=host.numpy())
        with torch.cuda.stream(self._copy_stream):
            dev = torch.empty((3, n), dtype=torch.float32, device=self.device)
            dev.copy_(host, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        self._copied[k] = done
        self._slot = (k + 1) % len(self._pinned)
        return dev

    def _stage(self, it: Iterator[np.ndarray]):
        """Pull + device-stage the next scan.  A malformed scan (bad shape,
        unparsable file) is counted as an error and skipped so one bad scan
        cannot kill the stream (SURVEY.md section 5 fault isolation).
        Returns (raw, device_scan, n_skipped); n_skipped errored scans were
        consumed from the source before this one (their stream positions are
        charged to ``_seq`` when this entry is processed or dropped —
        staging overlaps the in-flight scan, so ``_seq`` cannot move here).
        At stream end returns (None, None, n_skipped) so trailing malformed
        scans still get charged to ``_seq`` (checkpoint correctness: a
        resumed run must not re-consume and re-error them)."""
        skipped = 0
        while True:
            raw = next(it, None)
            if raw is None:
                return (None, None, skipped)
            try:
                return (raw, self._to_device(raw), skipped)
            except Exception as e:  # noqa: BLE001 — isolate any scan fault
                self.metrics.record_error(f"stage: {e!r}")
                skipped += 1

    def _warm_up(self) -> None:
        """On the card: build (or load) the kernels and make one tiny
        transfer before the clock starts, so the first scan pays for
        neither the nvcc build nor the CUDA context."""
        if self.device.type == "cuda":
            from urban_road_filter_torch import _build

            _build.library()
            torch.zeros(8, device=self.device).cpu()

    def run(self, source: Iterable[np.ndarray],
            max_scans: Optional[int] = None) -> StreamMetrics:
        self._warm_up()
        resume_at = self._load_checkpoint()
        it = iter(source)
        # Fast-forward a resumed stream.
        for _ in range(resume_at):
            next(it, None)
        self._seq = resume_at

        period = 1.0 / self.rate_hz if self.rate_hz > 0 else 0.0
        self.metrics.start()
        if self.pipeline_depth > 1:
            return self._run_pipelined(it, max_scans, period)
        next_deadline = time.perf_counter()

        # Double buffering: stage scan t+1 while scan t computes.
        pending = self._stage(it)  # (host_scan, device_scan, n_skipped)

        done = 0
        while pending[0] is not None and (max_scans is None or done < max_scans):
            raw, dev, skipped = pending
            self._seq += skipped  # errored scans consumed earlier positions
            t0 = time.perf_counter()
            err = None
            out = None
            try:
                out = self._process(dev)
            except Exception as e:  # noqa: BLE001 — per-scan isolation
                err = e
            t1 = time.perf_counter()  # dispatch done (async call returned)

            # Overlap: stage the next scan while the device works.
            pending = self._stage(it)
            t2 = time.perf_counter()  # next scan staged (H2D overlap)

            outputs = None
            if err is None:
                try:
                    # One synchronisation delivers every output the node
                    # publishes; latency_ms ends when they are in host
                    # memory, which is what a subscriber observes.
                    host = self._fetch_outputs(out)
                    t3 = time.perf_counter()
                    latency_ms = (t3 - t0) * 1e3
                    outputs = self._postprocess(
                        raw, host, latency_ms,
                        dispatch_ms=(t1 - t0) * 1e3,
                        stage_ms=(t2 - t1) * 1e3,
                        fetch_ms=(t3 - t2) * 1e3)
                    outputs.stats.post_ms = (
                        time.perf_counter() - t3) * 1e3
                except Exception as e:  # noqa: BLE001
                    err = e

            if err is None:
                self.metrics.record(outputs.stats)
                if self.on_scan:
                    self.on_scan(outputs)
            else:
                self.metrics.record_error(f"scan seq={self._seq}: {err!r}")
            self._seq += 1
            done += 1
            self._save_checkpoint()

            if period:
                next_deadline += period
                lag = time.perf_counter() - next_deadline
                if lag > 0 and self.drop_when_behind:
                    # Behind schedule: drop scans (queue depth 1).  Dropped
                    # scans are consumed RAW, never padded or staged, as the
                    # reference's queue-1 drop discards the message unparsed
                    # (lidar_segmentation.cpp:53).  A malformed dropped scan
                    # is a drop, not an error (it was never looked at).
                    n_skip = int(lag / period)
                    restage = False
                    for _ in range(n_skip):
                        if pending[0] is None:
                            break
                        self._seq += pending[2] + 1  # dropped scan's position
                        pending = (next(it, None), None, 0)
                        restage = True
                        self.metrics.record_drop()
                        next_deadline += period
                    if restage and pending[0] is not None:
                        # Stage the survivor (staging deferred during drops).
                        try:
                            pending = (pending[0],
                                       self._to_device(pending[0]), 0)
                        except Exception as e:  # noqa: BLE001
                            self.metrics.record_error(f"stage: {e!r}")
                            nxt = self._stage(it)
                            # the failed survivor occupies a stream position
                            pending = (nxt[0], nxt[1], nxt[2] + 1)
                    self._save_checkpoint()  # drops moved _seq: persist them
                elif lag < 0:
                    time.sleep(-lag)
        if pending[0] is None and pending[2]:
            # Trailing malformed scans were consumed from the stream; charge
            # their positions so a resume does not re-consume them.
            self._seq += pending[2]
            self._save_checkpoint()
        return self.metrics

    def _fetch_outputs(self, out):
        """Every output the node publishes, in host memory, in the order of
        _postprocess's host_out tuple.  ``out`` is a ScanResult (SP mode),
        packed_scan's (packed, markers, ok, num_rings, overflow) tuple or
        a checked scan's (CheckError, ScanResult), told apart by the
        concrete type: ScanResult first, since a NamedTuple is a tuple too.
        On the card, one non-blocking copy per field (a checked scan's
        error word too) into pinned memory, then one event
        synchronisation; a set error word raises after it."""
        err = None
        if (type(out) is tuple and len(out) == 2
                and isinstance(out[0], CheckError)):
            err, out = out
        if isinstance(out, ScanResult):
            fields = (out.labels, out.roi, out.probably_road, out.markers,
                      out.ok, out.num_rings, out.overflow)
        elif type(out) is tuple and len(out) == 5:
            fields = out
        else:
            raise TypeError(f"unexpected pipeline output {type(out)!r}")
        if err is not None:
            fields = (*fields, err.word)
        if self.device.type == "cuda":
            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for t in fields]
            for h, t in zip(host, fields):
                h.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            done.synchronize()
        else:
            host = fields
        host = tuple(h.numpy() for h in host)
        if err is not None:
            CheckError(host[-1]).throw()
            host = host[:-1]
        if isinstance(out, ScanResult):
            return host
        packed, markers, ok, rings, overflow = host
        labels, roi, prob = unpack_planes(packed)
        return labels, roi, prob, markers, ok, rings, overflow

    def _run_pipelined(self, it: Iterator[np.ndarray],
                       max_scans: Optional[int],
                       period: float) -> StreamMetrics:
        """pipeline_depth >= 2: keep up to `depth` dispatched scans in
        flight; fetch (deliver) the oldest when the pipe is full or input
        ran out.  Identical outputs, ordering and per-scan isolation as
        the depth-1 loop; positions of DROPPED scans ride the pending
        entry's skipped counter and are checkpointed at the next delivery
        (see __init__ note).

        Per-scan attribution at depth > 1: latency_ms spans dispatch ->
        outputs-in-host-memory (it includes time the scan waited behind
        older in-flight scans); stage_ms is 0 (staging is fully
        overlapped, charged to no scan) and fetch_ms = latency_ms -
        dispatch_ms, keeping the dispatch + stage + fetch == latency_ms
        invariant."""
        depth = self.pipeline_depth
        next_deadline = time.perf_counter()
        inflight: deque = deque()
        pending = self._stage(it)  # (host_scan, device_scan, n_skipped)
        done = 0
        dispatched = 0

        while True:
            # Fill the pipe (staging the next scan overlaps device work).
            while (pending[0] is not None and len(inflight) < depth
                   and (max_scans is None or dispatched < max_scans)):
                raw, dev, skipped = pending
                t0 = time.perf_counter()
                err = None
                out = None
                try:
                    out = self._process(dev)
                except Exception as e:  # noqa: BLE001 — per-scan isolation
                    err = e
                t1 = time.perf_counter()
                inflight.append((raw, skipped, out, err, t0, t1))
                dispatched += 1
                pending = self._stage(it)
            if not inflight:
                break

            raw, skipped, out, err, t0, t1 = inflight.popleft()
            self._seq += skipped  # errored/dropped earlier stream positions
            outputs = None
            if err is None:
                try:
                    host = self._fetch_outputs(out)
                    t3 = time.perf_counter()
                    latency_ms = (t3 - t0) * 1e3
                    dispatch_ms = (t1 - t0) * 1e3
                    outputs = self._postprocess(
                        raw, host, latency_ms,
                        dispatch_ms=dispatch_ms,
                        stage_ms=0.0,
                        fetch_ms=latency_ms - dispatch_ms)
                    outputs.stats.post_ms = (
                        time.perf_counter() - t3) * 1e3
                except Exception as e:  # noqa: BLE001
                    err = e

            if err is None:
                self.metrics.record(outputs.stats)
                if self.on_scan:
                    self.on_scan(outputs)
            else:
                self.metrics.record_error(f"scan seq={self._seq}: {err!r}")
            self._seq += 1
            done += 1
            self._save_checkpoint()

            if period:
                next_deadline += period
                lag = time.perf_counter() - next_deadline
                if lag > 0 and self.drop_when_behind:
                    # Queue-`depth` drops: discard from the staging
                    # frontier (in-flight scans always complete).  Dropped
                    # scans are consumed RAW — never staged — and their
                    # stream positions carry forward on the survivor's
                    # skipped counter (charged at its delivery).
                    n_skip = int(lag / period)
                    restage = False
                    for _ in range(n_skip):
                        if pending[0] is None:
                            break
                        pending = (next(it, None), None, pending[2] + 1)
                        restage = True
                        self.metrics.record_drop()
                        next_deadline += period
                    if restage and pending[0] is not None:
                        try:
                            pending = (pending[0],
                                       self._to_device(pending[0]),
                                       pending[2])
                        except Exception as e:  # noqa: BLE001
                            self.metrics.record_error(f"stage: {e!r}")
                            nxt = self._stage(it)
                            # the failed survivor occupies a stream position
                            pending = (nxt[0], nxt[1],
                                       nxt[2] + pending[2] + 1)
                elif lag < 0:
                    time.sleep(-lag)

        if pending[0] is None and pending[2]:
            # Trailing consumed positions (malformed and/or dropped).
            self._seq += pending[2]
            self._save_checkpoint()
        return self.metrics

    def _postprocess(self, raw, host_out, latency_ms: float,
                     dispatch_ms: float = 0.0, stage_ms: float = 0.0,
                     fetch_ms: float = 0.0) -> ScanOutputs:
        """Pure host work: ``host_out`` is the already-fetched
        (labels, roi, probably_road, markers, ok, num_rings, overflow)
        tuple, so nothing here touches the device."""
        # Scans larger than dims.max_points are truncated by the staging;
        # postprocess the processed prefix (the truncation is visible in
        # stats as points_in < len(raw)).
        n_in = min(len(raw), self.dims.max_points)
        raw = raw[:n_in]
        labels, roi, prob, markers, out_ok, out_rings, out_overflow = host_out
        labels = labels[:n_in]
        roi = roi[:n_in]
        prob = prob[:n_in]
        pts = raw[:, :4] if raw.shape[1] >= 4 else np.concatenate(
            [raw, np.zeros((n_in, 4 - raw.shape[1]), raw.dtype)], axis=1)
        sel = markers[:, 0] > 0
        rows = markers[sel][:, 1:5]
        strips = []
        if len(rows) > 2 and bool(out_ok):
            rows = rows.copy()
            rows[:, 3] = smooth_marker_flags(rows[:, 3])
            built, line_strip_id = build_line_strips(
                rows,
                polysimp_allow=self.cfg.simple_poly_allow,
                polysimp=self.cfg.poly_s_param,
                polyz=self.cfg.poly_z_manual,
                zavg_allow=self.cfg.poly_z_avg_allow)
            strips = self.tracker.finalize(built, line_strip_id)

        stats = ScanStats(
            seq=self._seq, ok=bool(out_ok), points_in=n_in,
            points_roi=int(roi.sum()), num_rings=int(out_rings),
            road_points=int((labels == LABEL_ROAD).sum()),
            curb_points=int((labels == LABEL_CURB).sum()),
            marker_count=int(sel.sum()), overflow=int(out_overflow),
            latency_ms=latency_ms, dispatch_ms=dispatch_ms,
            stage_ms=stage_ms, fetch_ms=fetch_ms)

        return ScanOutputs(
            seq=self._seq, ok=bool(out_ok),
            road=pts[(labels == LABEL_ROAD)],
            curb=pts[(labels == LABEL_CURB)],
            roi=pts[roi],
            road_probably=pts[prob],
            marker_strips=strips, stats=stats)


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description="urban_road_filter_torch replay")
    ap.add_argument("--scene", default="two_curbs")
    ap.add_argument("--npz", default=None, help="NPZ scan sequence path")
    ap.add_argument("--pcd-dir", default=None, help="directory of .pcd files")
    ap.add_argument("--bag", default=None, help="rosbag (v2.0) file")
    ap.add_argument("--bag-topic", default=None,
                    help="PointCloud2 topic in the bag (default: first found)")
    ap.add_argument("--scans", type=int, default=50)
    ap.add_argument("--rate-hz", type=float, default=0.0,
                    help="replay rate; 0 = as fast as possible")
    ap.add_argument("--no-drop", action="store_true",
                    help="lossless mode instead of queue-1 drop semantics")
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help="scans kept in flight (1 = the reference's strict "
                         "queue-1 serial loop; 2 overlaps host work and "
                         "transfers with the device step)")
    ap.add_argument("--azimuth-shard", type=int, default=0,
                    help="cut each scan into this many azimuth wedges "
                         "(sequence-parallel mode, all wedges on the one "
                         "card; must divide 360)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--config-json", default=None)
    ap.add_argument("--config", default=None,
                    help="config file, .json or .yaml by extension")
    ap.add_argument("--stats-jsonl", default=None,
                    help="write per-scan stats records to this file")
    ap.add_argument("--checked", action="store_true",
                    help="debug: the index contracts checked on the device "
                         "at every stage boundary (utils/checked.py); a "
                         "broken one fails its scan instead of being "
                         "masked silently")
    ap.add_argument("--follow", nargs="?", const="", default=None,
                    metavar="DIR",
                    help="live view (rviz follow analogue): window on an "
                         "interactive display, frame PNGs into DIR when "
                         "headless (default throttle 10 Hz)")
    ap.add_argument("--follow-rate", type=float, default=10.0,
                    help="max live-view redraw rate in Hz")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain PyTorch "
                         "twins of the kernels)")
    args = ap.parse_args()

    cfg = FilterConfig()
    if args.config:
        cfg = FilterConfig.from_file(args.config)
    elif args.config_json:
        with open(args.config_json) as f:
            cfg = FilterConfig.from_json(f.read())

    # Validate inputs before the device starts (fail fast on user errors).
    if args.bag:
        if not os.path.exists(args.bag):
            raise SystemExit(f"error: --bag file not found: {args.bag}")
        source = bag_source(args.bag, topic=args.bag_topic)
    elif args.npz:
        if not os.path.exists(args.npz):
            raise SystemExit(f"error: --npz file not found: {args.npz}")
        source = npz_source(args.npz)
    elif args.pcd_dir:
        if not os.path.isdir(args.pcd_dir):
            raise SystemExit(f"error: --pcd-dir not a directory: {args.pcd_dir}")
        source = pcd_dir_source(args.pcd_dir)
    else:
        from urban_road_filter_torch.io.synthetic import SCENES

        if args.scene not in SCENES:
            raise SystemExit(f"error: unknown scene {args.scene!r}; "
                             f"have {sorted(SCENES)}")
        source = scene_source(args.scene, n_scans=args.scans)

    sinks = []
    fh = open(args.stats_jsonl, "a") if args.stats_jsonl else None
    if fh is not None:
        sinks.append(lambda o: (fh.write(o.stats.to_json() + "\n"),
                                fh.flush()))
    if args.follow is not None:
        from urban_road_filter_torch.viz import LiveViewer

        sinks.append(LiveViewer(rate_hz=args.follow_rate,
                                out_dir=args.follow or None))
    sink = None
    if sinks:
        sink = lambda o: [s(o) for s in sinks]

    h = ReplayHarness(cfg=cfg, rate_hz=args.rate_hz,
                      drop_when_behind=not args.no_drop,
                      checkpoint_path=args.checkpoint, on_scan=sink,
                      azimuth_shard=args.azimuth_shard,
                      checked=args.checked,
                      pipeline_depth=args.pipeline_depth,
                      device=args.device)
    try:
        metrics = h.run(source, max_scans=args.scans)
    finally:
        if fh is not None:
            fh.close()
    print(json.dumps(metrics.summary()))


if __name__ == "__main__":
    main()
