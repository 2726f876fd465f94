"""Scans in, labels + markers out: the scan and batch pipelines on tensors.

Port of urban_road_filter_tpu/pipeline.py:99-212 (process_scan), :234-306
(the batch path), :271-296 (the packed wire plane) and :218-306 (the
compiled entry points process_scan_jit, packed_scan_jit and
process_batch_jit, here CUDA-graph replays).
Dataflow, on the card (or, for ``device="cpu"``, through the plain twins):

    points (one scan: rows (N, >=3) or planar (3, N); a batch: rows
    (B, N, >=3) or planar (3, B, N); named by ``layout``)
      -> ingest, once over the (B, N) streams (B = 1 for one scan):
         ROI mask, star keys, in-ROI count (K1), vertical angles, ring
         discovery (K2) and binning (K3)   (ops.ingest)
    then over a lane axis, one lane per scan (the JAX package's vmap),
    each kernel launched once for the batch:
      -> star-shaped search: <= 360 curb hits per lane (K4 ops.star), when
         cfg.star_shaped_method
      -> stable rank + placement into (B, rings, P), input order, the star
         hits scattered onto it        (K5 ops.rank, K6 ops.place)
      -> x-zero / z-zero curb stencils on the (B * rings, P) rows
                                       (K7 ops.stencil_kernels)
      -> blind-spot flood fill, with the markers' first pass
                                       (K8, K9 ops.blind_spots)
      -> markers on the unsorted layout (K10 ops.markers)
      -> labels back to input order, gated and packed (K11 ops.gather;
         one launch per 128 scans)
    One scan is the same code at B = 1.

Nothing here reads a value back to the host, so a CUDA scan or batch is
enqueued without a synchronisation.  The stages read the configuration's
dynamic half (config.DynConfig) from a device parameter buffer
(config.device_config: one cached buffer per value and device, so a run
of scans under one configuration makes no host-to-device copy for it).

The compiled entry points (``*_jit``) capture the same stages once per key
(the static half, dims, layout, input shape and dtype, how the input is
copied in, device) into a CUDA graph, with an input buffer and a parameter
buffer of their own, and replay it: a call copies its input in, writes the
parameter buffer only when the dynamic values changed (a hot swap, no
re-capture), replays, and returns copies of the graph's outputs.  A batch
in pinned host memory of at least two lane groups (LANE_GROUP lanes) goes
in by groups on a copy stream of its own, and the graph runs each group's
stages as soon as its lanes have landed, so the copy runs behind the
compute (_LaneGroups).  On the CPU the entries keep the same cache and
counts and run the plain twins on their parameter buffer.
While a torch profiler records, an entry's call sits in named ranges (its
copy-in, launch and clones apart) and replays a traced variant of its
graph, whose stages time themselves on the device (utils.profiling); the
plain graph is left as it was captured.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import numpy as np
import torch

from urban_road_filter_torch import _build
from urban_road_filter_torch.config import (
    DynConfig, FilterConfig, PipelineDims, bind_params, device_config,
    param_buffer, split_cached)
from urban_road_filter_torch.constants import MIN_POINTS
from urban_road_filter_torch.ops import geometry, ingest
from urban_road_filter_torch.ops.blind_spots import blind_spots
from urban_road_filter_torch.ops.gather import gather_pack, gather_pack_batch
from urban_road_filter_torch.ops.markers import marker_points
from urban_road_filter_torch.ops.star import star_hits, star_labels
from urban_road_filter_torch.ops.stencil_kernels import fused_xz_zero_
from urban_road_filter_torch.utils import profiling

I32 = torch.int32


# A pipeline stage: its profiler range ("urf::<stage>") while a profiler
# records, and inside a compiled entry's traced capture its timing events
# (utils.profiling.stage).
_stage = profiling.stage


class ScanResult(NamedTuple):
    """Per-scan outputs (all fixed-shape; the host slices by masks)."""

    ok: torch.Tensor  # 0-d bool: >= 30 points in ROI (lidar_segmentation.cpp:124)
    roi: torch.Tensor  # (N,) bool
    labels: torch.Tensor  # (N,) int8 in {0,1,2}; 0 for non-ROI points
    ring_id: torch.Tensor  # (N,) int32; dims.rings = dropped at binning
    num_rings: torch.Tensor  # 0-d int32
    counts: torch.Tensor  # (dims.rings,) int32
    max_distance: torch.Tensor  # (dims.rings,) f32
    markers: torch.Tensor  # (361, 6): exists, x, y, z, red, bin
    overflow: torch.Tensor  # 0-d int32: points dropped by ring capacity
    star_overflow: torch.Tensor  # 0-d int32, always 0 (schema of the JAX
    # package, whose star path keeps every point per beam)
    probably_road: torch.Tensor  # (N,) bool: cfg.probably_road_ring members


def _stages(x, y, z, valid, keys, ring_id, num_rings, cfg: FilterConfig,
            dims: PipelineDims, probe=None):
    """(label tables (B, R, P), pos (B, N), counts (B, R), max_distance
    (B, R), markers (B, 361, 6), overflow (B,)) of B scans after the
    ingest, up to their markers, every stage once over the lane axis: x,
    y, z, valid, ring_id (B, N) and num_rings (B,) from _ingest; keys are
    their star keys (fk, r_key), None with the star search off.  ``probe``
    (a dict) receives what each stage's kernels were given: "star" (x, y,
    z, valid, keys), "ring_id", "num_rings", and 1-tuples or pairs led by
    a copy of the layout: as placed ("placed", before K7), stenciled
    ("stenciled", with max_distance) and flooded ("flooded", with K9's
    kf)."""
    rings = dims.rings
    hp = None

    def keep(name, rl, *more):
        if probe is not None:
            probe[name] = (rl._replace(label=rl.label.clone()), *more)

    if probe is not None:
        probe.update(star=(x, y, z, valid, keys), ring_id=ring_id,
                     num_rings=num_rings)
    if keys is not None:
        with _stage("star"):
            hp = star_hits(x, y, z, valid, cfg, keys)
    with _stage("tensorize"):
        rl, pos, max_dist = geometry.tensorize(
            x, y, z, ring_id, dims.ring_capacity, rings=rings)
        if hp is not None:
            rl = rl._replace(label=star_labels(hp, ring_id, pos, rl.label))
    keep("placed", rl)
    with _stage("xz_zero"):  # the stage's own table: marked in place
        fused_xz_zero_(rl, cfg)
    keep("stenciled", rl, max_dist)
    with _stage("blind_spots"):
        rl, kf = blind_spots(rl, max_dist, num_rings, cfg)
    keep("flooded", rl, kf)
    with _stage("markers"):
        markers = marker_points(rl, num_rings, kf)
    return rl.label, pos, rl.counts, max_dist, markers, rl.overflow


def _ingest(x, y, z, cfg: FilterConfig, dims: PipelineDims):
    """(valid, fk, r_key, ring_id, num_rings, ok) of the scans of (B, N)
    coordinate views: K1-K3 once over the batch; fk and r_key are None with
    the star search off."""
    if x.dtype != torch.float32:
        raise TypeError(f"points must be float32, got {x.dtype}")
    with _stage("ingest"):
        valid, fk, r_key, piece = ingest.ingest_prep(
            x, y, z, cfg, want_star_keys=bool(cfg.star_shaped_method))
        _, alpha = geometry.vertical_angles(x, y, z)
        angles, num_rings = ingest.discover_rings(alpha, valid, cfg.interval,
                                                  dims.rings)
        ring_id = ingest.assign_rings(alpha, valid, angles, cfg.interval)
    return valid, fk, r_key, ring_id, num_rings, piece >= MIN_POINTS


def target_device(device=None) -> torch.device:
    """The device the entry points run on: ``device=None`` means "cuda".
    Without a CUDA device that raises unless the caller asked for the CPU
    (``device="cpu"``), the only way to run the plain twins."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch twins on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_device(pts, device=None) -> torch.Tensor:
    """The entry points' input on target_device(device); ``pts`` may be a
    tensor or a host array."""
    return torch.as_tensor(pts).to(target_device(device))


def _scan(pts, cfg: FilterConfig, dims: PipelineDims, layout: str, device):
    """_scan_on the scan on ``device`` under ``cfg``'s cached parameter
    buffer there."""
    pts = on_device(pts, device)
    return _scan_on(pts, device_config(cfg, pts.device), dims, layout)


def _scan_on(pts, cfg, dims: PipelineDims, layout: str):
    """(ScanResult, packed uint8 plane) of one scan on its device, ``cfg``
    bound to a parameter buffer there: the batch path at B = 1 (the ingest
    and the stages over a batch of one, the gather + pack of one lane), on
    the scan's own views."""
    x, y, z, _ = geometry.xyz_of(pts, layout)
    x, y, z = x[None], y[None], z[None]
    valid, fk, r_key, ring_id, num_rings, ok = _ingest(x, y, z, cfg, dims)
    table, pos, counts, max_dist, markers, overflow = (f[0] for f in _stages(
        x, y, z, valid, None if fk is None else (fk, r_key), ring_id,
        num_rings, cfg, dims))
    valid, ring_id, num_rings, ok = valid[0], ring_id[0], num_rings[0], ok[0]
    with _stage("gather"):
        labels, roi, probably_road, packed = gather_pack(
            table, ring_id, pos, valid, ok, int(cfg.probably_road_ring))
        markers = torch.where(ok, markers, 0.0)
    res = ScanResult(
        ok=ok, roi=roi, labels=labels, ring_id=ring_id, num_rings=num_rings,
        counts=counts, max_distance=max_dist, markers=markers,
        overflow=overflow,
        star_overflow=torch.zeros((), dtype=I32, device=x.device),
        probably_road=probably_road)
    return res, packed


def process_scan(pts, cfg: FilterConfig, dims: PipelineDims,
                 layout: str = "rows", device=None) -> ScanResult:
    """Label one padded scan: ``layout="rows"`` for (N, >=3) points
    (pad_scan), ``"planar"`` for (3, N) coordinate planes
    (pad_scan_planar).  The orientation is never guessed from the shape.
    Runs on ``device`` (default "cuda"; "cpu" for the plain twins), where
    the points are moved first.  On the card, issue one device's scans
    from one stream at a time: K1 and K9 count their blocks with
    per-device tickets, and a launch on a second stream while the first
    is still busy raises (_build.TICKETED)."""
    return _scan(pts, cfg, dims, layout, device)[0]


def packed_scan(pts, cfg: FilterConfig, dims: PipelineDims,
                layout: str = "rows", device=None):
    """process_scan with the three per-point planes packed into ONE uint8
    plane: labels in bits 0-1, roi in bit 2, probably_road in bit 3 (the
    JAX package's wire format).  Returns (packed, markers, ok, num_rings,
    overflow); unpack with unpack_planes."""
    res, packed = _scan(pts, cfg, dims, layout, device)
    return packed, res.markers, res.ok, res.num_rings, res.overflow


def process_batch(pts, cfg: FilterConfig, dims: PipelineDims,
                  layout: str = "rows", device=None) -> ScanResult:
    """Label a batch of padded scans: ``layout="rows"`` for (B, N, >=3)
    points, ``"planar"`` for (3, B, N) coordinate planes (planarize_batch).
    The ingest (K1-K3) runs once over the (B, N) streams, then every stage
    once over the lane axis (K4-K10 one launch each), and the gather +
    pack (K11) once per 128 lanes; nothing reads a value back to the
    host.  Returns
    a ScanResult with a leading B axis on every field (ok, num_rings,
    overflow and star_overflow are (B,); markers (B, 361, 6)): the per-point
    fields are the gather's (B, N) outputs themselves, so lane b of a field
    is a view of the batch's tensor (writing into it writes into the
    batch).  Lane b equals process_scan of scan b.  ``device`` and the
    one-stream rule as for process_scan."""
    pts = on_device(pts, device)
    return _batch_on(pts, device_config(cfg, pts.device), dims, layout)


def _batch_on(pts, cfg, dims: PipelineDims, layout: str,
              probe=None) -> ScanResult:
    """process_batch of a batch on its device, ``cfg`` bound to a
    parameter buffer there; ``probe`` as for _stages."""
    x, y, z, _ = geometry.xyz_of(pts, layout, batched=True)
    if x.shape[0] == 0:
        raise ValueError(f"empty batch: {tuple(pts.shape)}")
    valid, fk, r_key, ring_id, num_rings, ok = _ingest(x, y, z, cfg, dims)
    tables, pos, counts, max_dist, markers, overflow = _stages(
        x, y, z, valid, None if fk is None else (fk, r_key), ring_id,
        num_rings, cfg, dims, probe)
    with _stage("gather"):
        labels, roi, probably_road, _ = gather_pack_batch(
            tables, ring_id, pos, valid, ok, int(cfg.probably_road_ring))
        markers = torch.where(ok[:, None, None], markers, 0.0)
    return ScanResult(
        ok=ok, roi=roi, labels=labels, ring_id=ring_id, num_rings=num_rings,
        counts=counts, max_distance=max_dist, markers=markers,
        overflow=overflow,
        star_overflow=torch.zeros(ok.shape, dtype=I32, device=x.device),
        probably_road=probably_road)


# ---- the compiled entry points ----

# Captures per entry kind, as the JAX package's TRACE_COUNTS counts traces:
# one per new key; a change of dynamic parameters adds none.  "sp" counts
# the captures of the azimuth-sharded runs (parallel.azimuth_parallel).
CAPTURE_COUNTS = {"scan": 0, "packed": 0, "batch": 0, "sp": 0}
# The traced variants' captures per entry kind, apart: at most one an
# entry, on its first call while a profiler records.
TRACED_CAPTURES = {"scan": 0, "packed": 0, "batch": 0, "sp": 0}
# The batch calls whose input went in by lane groups (_LaneGroups), and
# the groups they made.
LANE_GROUP_COPIES = {"calls": 0, "groups": 0}

# Lanes a group of a batch copied in behind its compute (_LaneGroups).
# Smaller groups expose less of the first copy but add a body's fixed
# device cost per group; on one H100 with OS1-64 batches of 128, 32 came
# out ahead of 8, 16 and 64.
LANE_GROUP = 32

# The lane axis of a batch in each layout: (B, N, >=3) rows, (3, B, N)
# planar.
_LANE_AXIS = {"rows": 0, "planar": 1}

_compiled: dict = {}  # key -> _Compiled


def _packed_outputs(pts, cfg, dims, layout):
    res, packed = _scan_on(pts, cfg, dims, layout)
    return packed, res.markers, res.ok, res.num_rings, res.overflow


_BODIES = {"scan": lambda *a: _scan_on(*a)[0], "packed": _packed_outputs,
           "batch": _batch_on}


def _clones(out):
    outs = tuple(t.clone() for t in out)
    return out._make(outs) if hasattr(out, "_make") else outs


def grouped_copy_in(on_host: bool, pinned: bool, lanes: int,
                    group: int) -> bool:
    """Whether a batch of ``lanes`` lanes goes into the card by lane groups
    of ``group`` behind its compute: only from pinned host memory, whose
    copy runs on the copy engine without the host (a pageable copy blocks
    the host while it stages, a device copy-in is short), and only with
    two groups or more."""
    return on_host and pinned and lanes >= 2 * group


def lane_groups(lanes: int, group: int) -> list:
    """[(first lane, end lane)] of ``lanes`` lanes cut into groups of
    ``group``, the last group holding the rest."""
    return [(lo, min(lo + group, lanes)) for lo in range(0, lanes, group)]


def _lanes(pts, layout: str, lo: int, hi: int):
    """Lanes lo:hi of a batch, a view."""
    return pts[lo:hi] if layout == "rows" else pts[:, lo:hi]


def _batch_groups(body, pts, cfg, dims: PipelineDims, layout: str, groups,
                  landed=()) -> list:
    """[body over each lane group of a batch], in the order of ``groups``
    (lane_groups'); with ``landed``, one event per group, the current
    stream waits for a group's event before its stages."""
    outs = []
    for k, (lo, hi) in enumerate(groups):
        if landed:
            landed[k].wait()
        outs.append(body(_lanes(pts, layout, lo, hi), cfg, dims, layout))
    return outs


def _joined(outs) -> ScanResult:
    """The lane groups' ScanResults as one: every field a new (B, ...)
    tensor, each group's lanes written into its slice (one copy of every
    output, as _clones makes)."""
    return ScanResult(*(torch.cat(parts) for parts in zip(*outs)))


class _Compiled:
    """One compiled entry: its body, ``body(input, cfg, dims, layout)``
    (the stages, returning a ScanResult or a tuple of tensors), its
    parameter buffer (the cfg its stages see is bound to it), and on the
    card its input buffer, CUDA graph and the graph's outputs, the kernel
    launches the graph holds, and what its capture cost (``stats``: capture
    and instantiation ms, the graph's kernel, memcpy and memset nodes, the
    bytes its memory pool reserved).  ``traced``: (graph, outputs,
    profiling.StageEvents) of the traced variant, the same body captured
    again with timing events at its stage boundaries, on the first call
    made while a profiler records (None before); ``traced_stats`` its
    capture's stats."""

    def __init__(self, kind: str, body, st, dyn, dims: PipelineDims,
                 layout: str, pts: torch.Tensor):
        self.kind, self.body, self.dims, self.layout = kind, body, dims, layout
        dev = pts.device
        self.params = torch.empty((len(DynConfig._fields),),
                                  dtype=torch.float32, device=dev)
        self.cfg = bind_params(st, self.params)
        self.held = None  # the DynConfig params holds
        self.graph = None
        self.traced = None
        self.stats: dict = {}
        if dev.type == "cuda":
            self._capture(pts, dyn)

    def _write_params(self, dyn) -> None:
        """Make params hold ``dyn``: one device copy from its cached buffer
        when it changed (a hot swap), nothing otherwise."""
        if self.held != dyn:
            self.params.copy_(param_buffer(dyn, self.params.device))
            self.held = dyn

    def _capture(self, pts: torch.Tensor, dyn) -> None:
        """Capture the entry's stages into a CUDA graph, after one run of
        them on the current stream (it builds the kernels, fills the
        caches, and counts as launches).  A failed capture raises."""
        self.input = torch.empty(pts.shape, dtype=pts.dtype, device=pts.device)
        self.input.copy_(pts)
        self._write_params(dyn)
        self.body(self.input, self.cfg, self.dims, self.layout)
        self.graph, self.out, self.launches, _, self.stats = self._graph(
            contextlib.nullcontext())
        self.ticketed = [k for k in _build.TICKETED if k in self.launches]

    def _graph(self, around):
        """(graph, outputs, launches, what ``around`` yielded, stats) of
        the body captured on the entry's buffers inside the context
        ``around``.  A failed capture raises."""
        dev = self.input.device
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            with _build.recording() as launches:
                with torch.cuda.graph(graph):
                    # After the context emptied the allocator's cache: the
                    # graph's own pool grows from here.
                    reserved = torch.cuda.memory_reserved(dev)
                    with around as got:
                        out = self.body(self.input, self.cfg, self.dims,
                                        self.layout)
            t1 = time.perf_counter()
            graph.instantiate()
        except Exception as e:
            raise RuntimeError(f"{self.kind}: CUDA-graph capture failed "
                               f"({type(e).__name__}: {e})") from e
        t2 = time.perf_counter()
        stats = {"capture_ms": (t1 - t0) * 1e3,
                 "instantiate_ms": (t2 - t1) * 1e3,
                 "nodes": _build.graph_nodes(graph),
                 "pool_bytes": torch.cuda.memory_reserved(dev) - reserved}
        return graph, out, dict(launches), got, stats

    def __call__(self, pts, dyn, call: str | None = None):
        """The call: ``dyn`` into the parameter buffer, then on the card
        the input copied in, the graph replayed and its outputs cloned (on
        the CPU the body's run).  ``call``: the call's number while a
        profiler records (profiling.entry_call), None otherwise."""
        self._write_params(dyn)
        if call is not None:
            return self._traced_call(pts, call)
        if self.graph is None:  # the CPU: the plain twins, run each call
            return self.body(pts, self.cfg, self.dims, self.layout)
        # The ticket check (it may raise) before anything is enqueued.
        _build.replayed(self.launches, self.ticketed, self.input.device)
        self._copy_in(pts)
        self.graph.replay()
        return self._outputs(self.out)

    def _copy_in(self, pts) -> None:
        """The call's input into the input buffer, on the current stream."""
        self.input.copy_(pts, non_blocking=True)

    def _outputs(self, out):
        """The call's outputs: copies of the graph's ``out``."""
        return _clones(out)

    def _traced_call(self, pts, call: str):
        """__call__ while a profiler records: the traced variant replayed,
        each phase in its range (profiling's urf::stage_read, copy_in,
        launch, clone)."""
        span = profiling.span
        if self.graph is None:
            with span("urf::launch", call):
                return self.body(pts, self.cfg, self.dims, self.layout)
        if self.traced is None:
            graph, out, _, events, self.traced_stats = self._graph(
                profiling.timed_capture(self.kind))
            self.traced = (graph, out, events)
            TRACED_CAPTURES[self.kind] += 1
        graph, out, events = self.traced
        _build.replayed(self.launches, self.ticketed, self.input.device)
        with span("urf::stage_read", call):
            profiling.RECORD.settle(events)
        with span("urf::copy_in", call):
            self._copy_in(pts)
        with span("urf::launch", call):
            graph.replay()
        profiling.RECORD.replayed(events)
        with span("urf::clone", call):
            return self._outputs(out)


class _LaneGroups(_Compiled):
    """The batch entry for a batch in pinned host memory
    (grouped_copy_in): its input goes in by lane groups of LANE_GROUP on a
    copy stream of its own, each group's copy followed by its event, and
    the graph holds one body per group (``body`` over the group's lanes,
    _batch_groups), each after a wait on its group's event (an event-wait
    node), so group g + 1's copy runs while group g computes.  Compute
    stays on the current stream; only the copies leave it.  A call
    returns new (B, ...) fields, each group's outputs copied into its
    lanes (_joined), and counts in LANE_GROUP_COPIES."""

    def __init__(self, kind: str, body, st, dyn, dims: PipelineDims,
                 layout: str, pts: torch.Tensor):
        self.groups = lane_groups(pts.shape[_LANE_AXIS[layout]], LANE_GROUP)
        self.stream = torch.cuda.Stream(pts.device)
        self.landed = [torch.cuda.Event(external=True) for _ in self.groups]
        self.free = torch.cuda.Event()  # the current stream's work, per call

        def groups(pts, cfg, dims, layout):
            return _batch_groups(body, pts, cfg, dims, layout, self.groups,
                                 self.landed)

        super().__init__(kind, groups, st, dyn, dims, layout, pts)

    def _capture(self, pts: torch.Tensor, dyn) -> None:
        # An event exists from its first record on: the capture's waits
        # need theirs (a wait on an event never recorded enqueues nothing).
        for landed in self.landed:
            landed.record(self.stream)
        super()._capture(pts, dyn)

    def _copy_in(self, pts) -> None:
        """Each group's lanes into its lanes of the input buffer on the copy
        stream, each followed by its group's event, once the work already
        on the current stream (the last replay reads the buffer; the input
        may come from that stream's work) is done."""
        LANE_GROUP_COPIES["calls"] += 1
        LANE_GROUP_COPIES["groups"] += len(self.groups)
        self.free.record(torch.cuda.current_stream(self.input.device))
        self.stream.wait_event(self.free)
        planar = self.layout == "planar"
        with torch.cuda.stream(self.stream):
            for (lo, hi), landed in zip(self.groups, self.landed):
                dst = _lanes(self.input, self.layout, lo, hi)
                src = _lanes(pts, self.layout, lo, hi)
                # One contiguous block a plane: a strided copy from the
                # host would stage through pageable memory.
                for d, s in (zip(dst, src) if planar else ((dst, src),)):
                    d.copy_(s, non_blocking=True)
                landed.record()

    def _outputs(self, out) -> ScanResult:
        return _joined(out)


def compiled_entry(cache: dict, kind: str, body, pts, cfg: FilterConfig,
                   dims: PipelineDims, layout: str, device, make=_Compiled):
    """``(entry, pts, dyn)``: the entry of ``cache`` for this call's key
    (kind, static half of cfg, dims, layout, input shape and dtype, the
    entry's class ``make``, device), made on a miss (on the card:
    captured, and counted in CAPTURE_COUNTS[kind]) with ``body`` as its
    stages; ``entry(pts, dyn, call=None)`` is the call, which writes the
    dynamic half of cfg into the entry's parameter buffer."""
    dev = target_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    pts = torch.as_tensor(pts)
    if dev.type == "cpu":
        pts = pts.to(dev)
    st, dyn = split_cached(cfg)
    key = (kind, st, dims, layout, tuple(pts.shape), pts.dtype, make, dev)
    entry = cache.get(key)
    if entry is None:
        entry = make(kind, body, st, dyn, dims, layout,
                     pts.to(dev, non_blocking=True))
        cache[key] = entry
        CAPTURE_COUNTS[kind] += 1
    return entry, pts, dyn


def _run_compiled(kind: str, pts, cfg: FilterConfig, dims: PipelineDims,
                  layout: str, device, make=_Compiled):
    call = profiling.entry_call(kind)  # None unless a profiler records
    with profiling.entry_span(kind, call):
        entry, pts, dyn = compiled_entry(_compiled, kind, _BODIES[kind], pts,
                                         cfg, dims, layout, device, make)
        return entry(pts, dyn, call)


def _batch_entry(pts, layout: str, device) -> type:
    """The batch entry's class for this input: _LaneGroups where
    grouped_copy_in says so of a host tensor bound for the card."""
    if (isinstance(pts, torch.Tensor) and pts.ndim == 3
            and layout in _LANE_AXIS
            and target_device(device).type == "cuda"
            and grouped_copy_in(pts.device.type == "cpu", pts.is_pinned(),
                                pts.shape[_LANE_AXIS[layout]], LANE_GROUP)):
        return _LaneGroups
    return _Compiled


def compiled_entries() -> dict:
    """{key: entry} of every compiled entry point made in this process
    (each entry's ``stats`` on the card)."""
    return dict(_compiled)


def process_scan_jit(pts, cfg: FilterConfig, dims: PipelineDims,
                     layout: str = "rows", device=None) -> ScanResult:
    """process_scan as a CUDA-graph replay (on the CPU, the plain twins
    through the same cache).  The graph is captured once per (static
    half of cfg, dims, layout, input shape and dtype, device); a call under
    other dynamic values (config.DynConfig) writes them into the entry's
    parameter buffer and replays the same graph.  Returns new tensors,
    never overwritten by a later call."""
    return _run_compiled("scan", pts, cfg, dims, layout, device)


def packed_scan_jit(pts, cfg: FilterConfig, dims: PipelineDims,
                    layout: str = "rows", device=None):
    """packed_scan as a CUDA-graph replay, cached and hot-swapped as
    process_scan_jit.  Returns (packed, markers, ok, num_rings,
    overflow)."""
    return _run_compiled("packed", pts, cfg, dims, layout, device)


def process_batch_jit(pts, cfg: FilterConfig, dims: PipelineDims,
                      layout: str = "rows", device=None) -> ScanResult:
    """process_batch as a CUDA-graph replay (one ingest, the stages over
    the lane axis and one gather + pack over the batch in one graph),
    cached and
    hot-swapped as process_scan_jit.  Its per-point fields are new (B, N)
    tensors.  A batch in pinned host memory of at least 2 * LANE_GROUP
    lanes goes in by lane groups behind its compute (_LaneGroups), with
    the same results."""
    return _run_compiled("batch", pts, cfg, dims, layout, device,
                         _batch_entry(pts, layout, device))


def unpack_planes(packed):
    """Inverse of packed_scan's plane packing, on a host array or a tensor:
    (labels uint8, roi bool, probably_road bool)."""
    return packed & 3, (packed & 4) != 0, (packed & 8) != 0


def pad_scan(points, n: int) -> np.ndarray:
    """Host helper: pad/truncate (M, 4) to (n, 4) float32; zero rows are
    dropped by the ROI filter exactly like real missing returns."""
    pts = np.zeros((n, 4), np.float32)
    m = min(len(points), n)
    pts[:m, : points.shape[1]] = points[:m, :4]
    return pts


def pad_scan_planar(points, n: int, out: np.ndarray | None = None
                    ) -> np.ndarray:
    """pad_scan's planar twin: (M, >=3) -> (3, n) float32 x/y/z planes,
    written into ``out`` (a (3, n) float32 array, e.g. a pinned buffer's
    view) when given."""
    m = min(len(points), n)
    src = np.asarray(points, np.float32)[:m, :3].T
    if out is None:
        out = np.zeros((3, n), np.float32)
    else:
        out[:, m:] = 0.0
    out[:, :m] = src
    return out


def planarize_batch(batch) -> np.ndarray:
    """Host helper: (B, N, >=3) row-major batch -> contiguous (3, B, N)
    float32 planes."""
    return np.ascontiguousarray(
        np.asarray(batch, np.float32)[..., :3].transpose(2, 0, 1))
