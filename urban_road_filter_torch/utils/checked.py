"""Checked mode: the scan pipeline, its index contracts checked on the card.

Port of urban_road_filter_tpu/utils/checked.py.  The JAX module wraps
process_scan in checkify with ``index_checks``: every dynamic gather,
scatter or slice of the pipeline's address arithmetic (ring and slot
addresses, star hit pids, marker bins) gets an in-graph bounds predicate,
and the accumulated error is fetched once and raised on the host.

Here the address arithmetic runs in the kernels K1-K11 and the PyTorch glue
between them, whose guards make an out-of-range address silently wrong, as
XLA's clamped gathers do: ``star_labels`` drops a hit that lands outside
the layout, K11 reads 0 outside the table, the marker stage sends a slot
outside [0, 360] degrees to its dump bin.  Checked mode runs the stages of
``pipeline._scan``, the same calls in the same order (the flood stage as
the body of ``blind_spots``, whose window widths it checks), and at each stage
boundary evaluates the index contract of the addresses the next stage uses
(the index tensors a kernel is handed and the ones it writes), as torch
reductions on the device.  A broken contract sets its bit of one int32
device error word (``CONTRACTS``), read once per scan: ``CheckError.get``
names the broken contracts and the stage that produced each bad index.
The default path evaluates none of this and reads nothing back.

Scope, as in the JAX module:
  * index contracts only.  NaN and division checks are not ported: they
    trip on IEEE behaviour the reference shares (the star walk divides by
    dz/dr before masking invalid steps, star_shaped_search.cpp:116, and NaN
    coordinates flow through comparisons to be dropped, as in the C++).
  * the kernels themselves are not instrumented (nor does checkify reach
    the JAX package's Pallas kernels): their inputs and outputs are.
"""

from __future__ import annotations

import math

import torch

from urban_road_filter_torch import pipeline as P
from urban_road_filter_torch.config import FilterConfig, PipelineDims
from urban_road_filter_torch.constants import LABEL_ROAD
from urban_road_filter_torch.ops import blind_spots as bs
from urban_road_filter_torch.ops import geometry
from urban_road_filter_torch.ops.markers import N_BINS, NO_KEY
from urban_road_filter_torch.pipeline import ScanResult

I32 = torch.int32
I64 = torch.int64

# Contract name -> (bit of the error word, the stage that produces the
# index, what must hold).
CONTRACTS = {
    "ring_id": (0, "ingest (K3 assign_rings)",
                "ring_id in [0, rings], rings for every point outside the "
                "ROI, below num_rings for every point it bins"),
    "num_rings": (1, "ingest (K2 discover_rings)",
                  "0 <= num_rings <= rings"),
    "pos": (2, "tensorize (K5 group_rank, K6 group_place)",
            "the placed points' (ring, slot) addresses are the slots below "
            "counts[ring] <= capacity, each once; pos >= capacity exactly "
            "for the overflow points"),
    "star_pid": (3, "star (K4 star_walk)",
                 "every hit pid in [0, N], each hit an ROI point"),
    "flood_window": (4, "blind_spots (window_widths)",
                     "a window width >= 0 on every active ring holding "
                     "points (a NaN or negative width orders a window's "
                     "bounds lo > hi, which K8 and K9 read as empty)"),
    "marker_bin": (5, "markers (the layout's azimuth bins)",
                   "floor(alpha) in [0, 361) for every slot below counts on "
                   "a ring below num_rings with a non-NaN azimuth"),
    "marker_read": (6, "blind_spots (K9 kf), markers (K10)",
                    "each bin's first non-road key and each marker's point "
                    "address a slot below counts on a ring below "
                    "num_rings, in that bin"),
    "gather_addr": (7, "gather (K11's addresses)",
                    "ring * P + pos in [ring * P, (ring + 1) * P) for every "
                    "ROI point K11 reads (binned, not overflowed)"),
}
INDEX_ERRORS = frozenset(CONTRACTS)


class IndexContractError(RuntimeError):
    """A checked scan broke an index contract (CheckError.throw)."""


class CheckError:
    """The error word of one checked scan: the part of checkify's Error API
    that callers use.  ``word`` is a 0-d int32 tensor (on the device until
    read) or a host integer / array; reading it synchronises."""

    def __init__(self, word):
        self.word = word

    def broken(self) -> list:
        """Names of the broken contracts, in bit order."""
        w = int(self.word)
        return [name for name, (bit, _, _) in CONTRACTS.items()
                if (w >> bit) & 1]

    def get(self):
        """The message naming each broken contract and its stage, or None."""
        names = self.broken()
        if not names:
            return None
        return "index contracts broken: " + "; ".join(
            f"{n} (from {CONTRACTS[n][1]}: {CONTRACTS[n][2]})"
            for n in names)

    def throw(self) -> None:
        msg = self.get()
        if msg is not None:
            raise IndexContractError(msg)


class _Word:
    """The device error word being built: each selected contract ORs its
    bit in, from a 0-d bool tensor ("broken"), with no host read."""

    def __init__(self, errors: frozenset, device):
        self.errors = errors
        self.word = torch.zeros((), dtype=I32, device=device)

    def check(self, name: str, broken) -> None:
        """broken: a thunk returning the 0-d bool tensor; evaluated only
        when ``name`` is selected."""
        if name in self.errors:
            self.word = self.word | (broken().to(I32) << CONTRACTS[name][0])


def broken_num_rings(num_rings, rings: int):
    return (num_rings < 0) | (num_rings > rings)


def broken_ring_id(ring_id, valid, num_rings, rings: int):
    bad = ((ring_id < 0) | (ring_id > rings)
           | (~valid & (ring_id != rings))
           | ((ring_id < rings) & (ring_id >= num_rings)))
    return bad.any()


def broken_star_pid(hp, valid):
    n = valid.shape[0]
    bad = (hp < 0) | (hp > n)
    if n:
        hit = (hp > 0) & ~bad
        bad = bad | (hit & ~valid[torch.clamp(hp - 1, 0, n - 1).long()])
    return bad.any()


def broken_pos(ring_id, pos, counts, overflow, rings: int, cap: int):
    dev = pos.device
    in_ring = (ring_id >= 0) & (ring_id < rings)
    placed = in_ring & (pos >= 0) & (pos < cap)
    addr = torch.where(placed, ring_id.long() * cap + pos.long(), rings * cap)
    hits = torch.zeros((rings * cap + 1,), dtype=I32, device=dev)
    hits.index_add_(0, addr, torch.ones_like(pos))
    below = (torch.arange(cap, device=dev)[None, :] < counts[:, None])
    return ((counts < 0).any() | (counts > cap).any()
            | (hits[:-1] != below.reshape(-1).to(I32)).any()
            | (in_ring & (pos < 0)).any()
            | (overflow != (in_ring & (pos >= cap)).sum()))


def broken_flood_window(w, counts, num_rings):
    rings = w.shape[0]
    active = (torch.arange(rings, device=w.device) < num_rings) & (counts > 0)
    return (active & ~(w >= 0)).any()


def _active_slots(alpha, counts, num_rings):
    r, p = alpha.shape
    dev = alpha.device
    return ((torch.arange(p, device=dev)[None, :] < counts[:, None])
            & (torch.arange(r, device=dev)[:, None] < num_rings))


def broken_marker_bin(alpha, counts, num_rings):
    b = torch.floor(alpha)
    bad = (_active_slots(alpha, counts, num_rings) & ~torch.isnan(alpha)
           & ~((b >= 0) & (b < N_BINS)))
    return bad.any()


def broken_marker_read(layout: geometry.RingLayout, num_rings, kf, markers):
    """kf: (361,) int64 keys (ring << 48 | bits(alpha) << 16 | slot) that
    K9 wrote and K10 reads; markers: K10's (361, 6) table."""
    alpha, counts = layout.alpha, layout.counts
    r, p = alpha.shape
    dev = alpha.device
    bins = torch.arange(N_BINS, device=dev)
    # Each first non-road key addresses an active slot of its own bin.
    ring, slot = kf >> 48, kf & 0xFFFF
    rc = torch.clamp(ring, 0, max(r - 1, 0))
    a = alpha[rc, torch.clamp(slot, 0, p - 1)]
    good = ((ring >= 0) & (ring < num_rings) & (slot < counts[rc])
            & (torch.floor(a) == bins))
    bad = ((kf != NO_KEY) & ~good).any()
    # Each marker's point is a road slot of its bin (K10's winner read).
    active = _active_slots(alpha, counts, num_rings) & (alpha >= 0) & (
        alpha <= 360.0)
    bin_of = torch.where(active, torch.floor(alpha).to(I64), N_BINS)
    want = torch.cat([markers[:, 1:4],
                      torch.full((1, 3), math.nan, device=dev)])[bin_of]
    match = (active & (layout.label == LABEL_ROAD)
             & (layout.x == want[..., 0]) & (layout.y == want[..., 1])
             & (layout.z == want[..., 2]))
    found = torch.zeros((N_BINS + 1,), dtype=I32, device=dev)
    found.index_add_(0, bin_of.reshape(-1), match.reshape(-1).to(I32))
    exists = markers[:, 0] > 0
    return (bad | (exists & (found[:N_BINS] == 0)).any()
            | (markers[:, 5] != bins).any())


def broken_gather_addr(ring_id, pos, valid, rings: int, cap: int):
    reads = valid & (ring_id < rings) & (pos < cap)
    return (reads & ((ring_id < 0) | (pos < 0))).any()


def _selected(errors) -> frozenset:
    errors = INDEX_ERRORS if errors is None else frozenset(errors)
    unknown = errors - INDEX_ERRORS
    if unknown:
        raise ValueError(f"unknown index contracts {sorted(unknown)}; "
                         f"have {sorted(INDEX_ERRORS)}")
    return errors


def _checked_scan(pts, cfg: FilterConfig, dims: PipelineDims, errors,
                  layout: str, device, probe):
    """(ScanResult, device error word): pipeline._scan's stages with the
    contracts checked at their boundaries."""
    x, y, z, _ = geometry.xyz_of(P.on_device(pts, device), layout)
    rings, cap = dims.rings, dims.ring_capacity
    word = _Word(errors, x.device)
    valid, fk, r_key, ring_id, num_rings, ok = (
        f if f is None else f[0]
        for f in P._ingest(x[None], y[None], z[None], cfg, dims))
    word.check("num_rings", lambda: broken_num_rings(num_rings, rings))
    word.check("ring_id",
               lambda: broken_ring_id(ring_id, valid, num_rings, rings))
    hp = None
    if fk is not None:
        with P._stage("star"):
            hp = P.star_hits(x, y, z, valid, cfg, (fk, r_key))
        word.check("star_pid", lambda: broken_star_pid(hp, valid))
    with P._stage("tensorize"):
        rl, pos = geometry.tensorize(x, y, z, ring_id, cap, rings=rings)
        max_dist = geometry.max_distance(rl)
        if hp is not None:
            rl = rl._replace(label=P.star_labels(hp, ring_id, pos, rings,
                                                 cap))
    word.check("pos", lambda: broken_pos(ring_id, pos, rl.counts,
                                         rl.overflow, rings, cap))
    with P._stage("xz_zero"):
        P.fused_xz_zero_(rl, cfg)
    with P._stage("blind_spots"):  # blind_spots(), its widths kept
        w = bs.window_widths(max_dist, cfg.beam_zone)
        blocked = bs.flood_blocked(rl, w, cfg.beam_zone)
        reach_f, reach_b = bs.sweep_reach(rl, blocked, w, num_rings, cfg)
        label, kf = bs.flood_labeled(rl, reach_f, reach_b, w, cfg.beam_zone,
                                     num_rings)
        rl = rl._replace(label=label)
    word.check("flood_window",
               lambda: broken_flood_window(w, rl.counts, num_rings))
    word.check("marker_bin",
               lambda: broken_marker_bin(rl.alpha, rl.counts, num_rings))
    with P._stage("markers"):
        markers = P.marker_points(rl, num_rings, kf)
    word.check("marker_read",
               lambda: broken_marker_read(rl, num_rings, kf, markers))
    word.check("gather_addr",
               lambda: broken_gather_addr(ring_id, pos, valid, rings, cap))
    with P._stage("gather"):
        labels, roi, probably_road, _ = P.gather_pack(
            rl.label, ring_id, pos, valid, ok, int(cfg.probably_road_ring))
    if probe is not None:
        probe.update(valid=valid, ring_id=ring_id, num_rings=num_rings,
                     hp=hp, pos=pos, layout=rl, w=w, kf=kf,
                     markers=markers)
    res = ScanResult(
        ok=ok, roi=roi, labels=labels, ring_id=ring_id, num_rings=num_rings,
        counts=rl.counts, max_distance=max_dist,
        markers=torch.where(ok, markers, 0.0), overflow=rl.overflow,
        star_overflow=torch.zeros((), dtype=I32, device=x.device),
        probably_road=probably_road)
    return res, word.word


def process_scan_checked(pts, cfg: FilterConfig, dims: PipelineDims,
                         errors=None, throw: bool = True,
                         layout: str = "rows", device=None, probe=None):
    """process_scan with its index contracts checked on the device.

    Returns the ScanResult, equal to process_scan's field for field; raises
    IndexContractError naming each broken contract and its stage when
    ``throw`` (the error word is read, once), else returns (CheckError,
    result) without reading it.  ``errors``: the contracts to check, a
    subset of INDEX_ERRORS (default: all).  ``layout`` and ``device`` as for
    process_scan.  ``probe``: a dict that receives the scan's index tensors
    (chip_smoke.py holds each contract against corrupted copies of them)."""
    errors = _selected(errors)
    out, word = _checked_scan(pts, cfg, dims, errors, layout, device, probe)
    err = CheckError(word)
    if not throw:
        return err, out
    err.throw()
    return out


__all__ = ["process_scan_checked", "INDEX_ERRORS", "CONTRACTS", "CheckError",
           "IndexContractError", "ScanResult"]
