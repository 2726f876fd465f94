"""Azimuth-sharded (sequence-parallel, "SP") pipeline for one scan.

Port of urban_road_filter_tpu/parallel/azimuth_parallel.py.  One scan's
points are cut into contiguous azimuth wedges, and every stage runs per
wedge, with collectives where a dependency crosses wedges:

  * ring discovery is global and input-order dependent;
  * the per-ring max radius is a pmax;
  * the x/z-zero windows cross wedge boundaries: every wedge's head and
    tail blocks are gathered, and each wedge rebuilds its halo from them;
  * the flood fill's blocked bits are OR-ed over wedges, the blind-spot
    quadrant extremes max/min-combined;
  * the markers are two passes of K14 with the global scan position: each
    wedge's first non-road position f is min-combined, and the second pass,
    floored by that global f, gives each wedge's share of the farthest road
    point, which max/min/sum combines finish;
  * the per-point outputs: each wedge writes its points' labels and ring
    ids into zeros at their input positions, and a sum joins them.

The wedges live on one card (``LocalWedges``: every per-wedge value
stacked on a leading wedge axis and reduced over it) or are spread over
the ranks of a torch.distributed process group (``RankWedges``: each rank
holds ``local`` contiguous wedges, reduces over them, then over the
group).  Every rank runs the partition and the ring discovery on the whole
scan, as the JAX path's pre-pass does, and the stages after them on its
own wedges.  The kernels run once over the local wedges where a kernel
takes a wedge axis (K7, K8, K14), a batch (K3) or groups (K5, K6: a ring
of local wedge w is group w * rings + ring), and per wedge, on views of
the stacked tensors, otherwise (K4, K12).

Semantics kept from the JAX SP path (not the single-device one): inside a
ring the point order is (wedge, local input order), which equals input
order on azimuth-ordered scans, as spinning sensors emit them; star beams
never straddle wedges (a wedge is a whole number of 1-degree beam
sectors, so 360 % n_wedges == 0); points beyond a wedge's capacity are
dropped and counted in ``overflow``.

The whole run is one CUDA graph per key, replayed, with the dynamic
parameters in the entry's device buffer (make_azimuth_pipeline; the JAX
run is one jax.jit of the partition and the shard_map): on one card, and
on each rank of an NCCL group, whose graph holds the rank's collectives.
Over a gloo group on a card it runs op by op: gloo stages each collective
through host memory, which no graph can hold.

The JAX path finds the rings with a 64-step loop that picks the globally
first unmatched point through an all_gather.  That is the greedy of K2 over
the scan in input order restricted to the points that fit in their wedge,
so the port runs K2 once there (the tests pin num_rings and ring_id
against the JAX path).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from urban_road_filter_torch.config import (
    FilterConfig, PipelineDims, device_config)
from urban_road_filter_torch.constants import (
    LABEL_CURB, MIN_POINTS, STAR_REP)
from urban_road_filter_torch.ops import geometry, ingest
from urban_road_filter_torch.ops import blind_spots as bs
from urban_road_filter_torch.ops.geometry import F32, I32, RingLayout
from urban_road_filter_torch.ops.marker_state import F_NONE, marker_state
from urban_road_filter_torch.ops.markers import N_BINS
from urban_road_filter_torch.ops.place import group_place
from urban_road_filter_torch.ops.rank import group_positions
from urban_road_filter_torch.ops.star import star_hits
from urban_road_filter_torch.ops.stencil_kernels import fused_xz_zero_halo
from urban_road_filter_torch.pipeline import (
    ScanResult, _stage, compiled_entry, on_device, target_device)
from urban_road_filter_torch.utils import profiling


class LocalWedges:
    """The SP collectives for one rank that holds every wedge on one card:
    ``local == size``, each wedge's value stacked on a leading wedge axis.

    The wedge interface (RankWedges is the same over several ranks):
      * ``all_gather(t)``: (local, ...) -> (size, ...), global wedge order;
      * ``psum`` / ``pmax`` / ``pmin(t)``: this rank's values stacked on a
        leading axis (its wedges', or one entry of its own) -> their sum /
        max / min over every rank;
      * ``index()``: (local,) global indices of the wedges held here;
      * ``all_index()``: arange(size);
      * ``before(t)``: t gathered, (size, ...) -> this rank's (local, ...)
        exclusive prefix sum over the wedges before each.
    A psum of a tensor already gathered would count every rank's entries
    once per rank: sum a gathered tensor over its axis instead."""

    def __init__(self, size: int):
        self.size = size
        self.local = size
        self.first = 0  # global index of the first wedge held here
        self.census: dict = {}  # no collective: nothing leaves the card

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        return t.sum(0, dtype=t.dtype)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        return t.amax(0)

    def pmin(self, t: torch.Tensor) -> torch.Tensor:
        return t.amin(0)

    def index(self, device=None) -> torch.Tensor:
        return torch.arange(self.size, device=device)

    def all_index(self, device=None) -> torch.Tensor:
        return torch.arange(self.size, device=device)

    def before(self, t: torch.Tensor) -> torch.Tensor:
        return torch.cumsum(t, 0, dtype=t.dtype) - t


# The dtypes that cross the wire, contiguous, so that NCCL and gloo (on
# the CPU or the card) both take them; neither backend takes bool reliably,
# so masks go as uint8.
_WIRE_DTYPES = (torch.int32, torch.uint8, torch.float32)
# The all_gather into one tensor: all_gather_single where PyTorch has it
# (from there on all_gather_into_tensor is its deprecated alias, which
# warns), all_gather_into_tensor where it has only that (2.11 does).
_all_gather_single = (getattr(dist, "all_gather_single", None)
                      or dist.all_gather_into_tensor)


class RankWedges:
    """The wedge interface of LocalWedges over the ranks of a
    torch.distributed process group: rank r holds the ``local = size //
    world`` global wedges r * local ... r * local + local - 1, contiguous
    in azimuth.  A combine reduces over the local axis, then all_reduces
    over the group; all_gather gathers into one (world * local, ...)
    tensor, rank r's rows at r * local.  Only all_gather, all_reduce and
    broadcast run, on contiguous int32, uint8 or float32 tensors.
    ``census`` counts the collectives since it was last cleared by kind,
    {kind: {"calls", "bytes"}}, the bytes being each call's result on one
    rank."""

    def __init__(self, size: int, group):
        world = dist.get_world_size(group)
        if size % world != 0:
            raise ValueError(f"{size} wedges do not split evenly over "
                             f"{world} ranks")
        self.group = group
        self.world = world
        self.size = size
        self.local = size // world
        self.first = dist.get_rank(group) * self.local
        self.census: dict = {}

    def _count(self, kind: str, t: torch.Tensor) -> None:
        c = self.census.setdefault(kind, {"calls": 0, "bytes": 0})
        c["calls"] += 1
        c["bytes"] += t.numel() * t.element_size()

    @staticmethod
    def _wire(t: torch.Tensor) -> torch.Tensor:
        t = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        if t.dtype not in _WIRE_DTYPES:
            raise TypeError(f"no collective takes {t.dtype} here")
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        wire = self._wire(t)
        out = wire.new_empty((self.world * wire.shape[0], *wire.shape[1:]))
        _all_gather_single(out, wire, group=self.group)
        self._count("all_gather", out)
        return out.bool() if t.dtype == torch.bool else out

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        t = self._wire(t)
        dist.all_reduce(t, op=op, group=self.group)
        self._count("all_reduce", t)
        return t

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t.sum(0, dtype=t.dtype), dist.ReduceOp.SUM)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t.amax(0), dist.ReduceOp.MAX)

    def pmin(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t.amin(0), dist.ReduceOp.MIN)

    def index(self, device=None) -> torch.Tensor:
        return torch.arange(self.first, self.first + self.local,
                            device=device)

    def all_index(self, device=None) -> torch.Tensor:
        return torch.arange(self.size, device=device)

    def before(self, t: torch.Tensor) -> torch.Tensor:
        return (torch.cumsum(t, 0, dtype=t.dtype) - t)[
            self.first:self.first + self.local]


def azimuth_sorted(scan: np.ndarray) -> np.ndarray:
    """Host helper: the (M, >=3) scan's rows in order of the pipeline's
    2-D azimuth, NaN azimuths last, ties in input order: the order a
    spinning sensor emits, which the SP path's ring order assumes."""
    from urban_road_filter_torch.oracle.reference import azimuth_2d

    _, aa = azimuth_2d(np.asarray(scan[:, 0], np.float32),
                       np.asarray(scan[:, 1], np.float32))
    return scan[np.argsort(np.where(np.isnan(aa), 1e30, aa), kind="stable")]


def wedge_of(fk: torch.Tensor, valid: torch.Tensor, n_wedges: int):
    """Wedge of each point from its star beam fk (ingest K1's sector), so a
    beam never straddles wedges: the beam's sector of the 2-D azimuth,
    (fk + 90) mod 360, cut into n_wedges equal arcs (the JAX _wedge_of);
    n_wedges for a point outside the ROI.  A sector-360 point already has
    beam 0 (ingest_prep)."""
    w = ((fk + 90) % STAR_REP) // (STAR_REP // n_wedges)
    return torch.where(valid, w, n_wedges).to(I32)


def _rows(layout: RingLayout, w: int, rings: int) -> RingLayout:
    """Wedge w's (rings, P) view of a stacked (D * rings, P) layout."""
    sl = slice(w * rings, (w + 1) * rings)
    return layout._replace(**{f: getattr(layout, f)[sl] for f in (
        "x", "y", "z", "d2", "alpha", "label", "pid", "counts")})


def _halo(lw, layout: RingLayout, rings: int, cp: int):
    """The cp points just before and just after each local wedge's segment
    of each ring, over any number of thin neighbouring wedges (the JAX
    _halo_exchange): from every wedge's (rings, cp) tail and head blocks,
    all gathered (their valid masks in one gather, their x/y/z in
    another), wedge me keeps the last cp valid entries of the tails of
    wedges < me (left, right-aligned) and the first cp of the heads of
    wedges > me (right, left-aligned).  Returns (left, right) dicts of
    (local, R, cp) blocks and their valid counts "n" (local, R)."""
    loc, d = lw.local, lw.size
    cap = layout.x.shape[1]
    dev = layout.x.device
    counts = layout.counts.view(loc, rings, 1)
    k = torch.arange(cp, device=dev)
    tail_idx = torch.clamp(counts - cp + k, 0, cap - 1)
    tail_ok = counts - cp + k >= 0  # (local, R, cp)
    valid = lw.all_gather(torch.stack([tail_ok, k < counts], 1))
    blocks = []
    for name in ("x", "y", "z"):
        a = getattr(layout, name).view(loc, rings, cap)
        blocks.append(torch.where(tail_ok, torch.gather(a, 2, tail_idx), 0.0))
    for name in ("x", "y", "z"):
        # Rows shorter than cp (a ring capacity under curb_points) give a
        # head block of cp columns all the same; the columns past the row
        # are invalid (the head mask), so zeros fill them.
        a = getattr(layout, name).view(loc, rings, cap)
        blocks.append(a[:, :, :cp] if cap >= cp else
                      torch.nn.functional.pad(a, (0, cp - cap)))
    blocks = lw.all_gather(torch.stack(blocks, 1))  # (D, 6, R, cp)
    me = lw.index(dev)
    wedge = lw.all_index(dev)

    def compact(tape_valid, tape, left: bool):
        use = ((wedge[None, :] < me[:, None]) if left
               else (wedge[None, :] > me[:, None]))  # (me, wedge)
        valid = (tape_valid[None] & use[:, :, None, None]).permute(
            0, 2, 1, 3).reshape(loc, rings, d * cp)
        cols = torch.arange(d * cp, device=dev)
        order = torch.argsort(torch.where(valid, cols, d * cp), dim=-1,
                              stable=True)
        nv = valid.sum(-1, dtype=I32)[..., None]  # (me, R, 1)
        if left:
            sel = torch.clamp(nv - cp + k, 0, d * cp - 1)
            out_valid = nv - cp + k >= 0
        else:
            sel = torch.clamp(k.expand(loc, rings, cp), 0, d * cp - 1)
            out_valid = k < nv
        take = torch.gather(order, 2, sel.long())
        out = {}
        for name, t in tape.items():
            flat = t.permute(1, 0, 2).reshape(1, rings, d * cp).expand(
                loc, rings, d * cp)
            out[name] = torch.where(out_valid, torch.gather(flat, 2, take),
                                    0.0)
        out["n"] = torch.clamp(nv[..., 0], max=cp)
        return out

    return (compact(valid[:, 0], {n: blocks[:, i] for i, n in
                                  enumerate("xyz")}, True),
            compact(valid[:, 1], {n: blocks[:, 3 + i] for i, n in
                                  enumerate("xyz")}, False))


def _halo_stencils(lw, layout: RingLayout, rings: int, cfg: FilterConfig,
                   counts_g: torch.Tensor, probe=None) -> None:
    """The x/z-zero curb marks of the stacked layout, written into its
    label: every local wedge's ring segment with the halo points around
    it, the reference's j-range gate and the newY ladder at GLOBAL ring
    positions (the JAX _extend_with_halo, _x_zero_halo, _z_zero_halo), K7
    in one launch over the local wedges.  counts_g: (size, R) every
    wedge's ring counts, all gathered."""
    left, right = _halo(lw, layout, rings, int(cfg.curb_points))
    prefix, total = lw.before(counts_g), counts_g.sum(0, dtype=I32)
    if probe is not None:
        probe["halo"] = (layout._replace(label=layout.label.clone()), left,
                         right, prefix, total)
    fused_xz_zero_halo(layout, left, right, prefix, total, cfg,
                       n_wedges=lw.size)


def _quadrants(lw, layout: RingLayout, rings: int):
    """The blind-spot quadrant extremes of ring 1's curbs, each wedge's
    max/min combined (the JAX _blind_spots_sharded's pmax/pmin): the two
    maxima in one pmax, the two minima in one pmin."""
    loc = lw.local
    cap = layout.alpha.shape[1]
    a1 = layout.alpha.view(loc, rings, cap)[:, 1]
    counts1 = layout.counts.view(loc, rings)[:, 1]
    slot = torch.arange(cap, device=a1.device)
    curb1 = ((slot < counts1[:, None])
             & (layout.label.view(loc, rings, cap)[:, 1] == LABEL_CURB))
    r1 = (a1 >= 0) & (a1 < 90)
    r2 = (a1 >= 90) & (a1 < 180)
    r3 = (a1 >= 180) & (a1 < 270)
    r4 = ~(r1 | r2 | r3) & ~torch.isnan(a1)

    def mx(r):
        return torch.amax(torch.where(curb1 & r, a1, -math.inf), 1)

    def mn(r):
        return torch.amin(torch.where(curb1 & r, a1, math.inf), 1)

    mx1, mx3 = lw.pmax(torch.stack([mx(r1), mx(r3)], 1))
    mn2, mn4 = lw.pmin(torch.stack([mn(r2), mn(r4)], 1))
    return (torch.where(mx1 > 0, mx1, 0.0), torch.where(mn2 < 180, mn2, 180.0),
            torch.where(mx3 > 180, mx3, 180.0),
            torch.where(mn4 < 360, mn4, 360.0))


def _blind_spots(lw, layout: RingLayout, rings: int, max_dist, num_rings,
                 cfg: FilterConfig, probe=None) -> torch.Tensor:
    """Labels of the stacked layout after the flood fill: K8 over the local
    wedges in one launch, its blocked bits OR-ed over all wedges (a pmax
    of bytes; the JAX path's psum > 0), the global quadrant gate, then K12
    per local wedge (the JAX _blind_spots_sharded)."""
    bz = cfg.beam_zone
    w = bs.window_widths(max_dist, bz)
    wedges = [_rows(layout, k, rings) for k in range(lw.local)]
    blocked = lw.pmax(torch.stack(
        bs.flood_blocked(layout, w, bz, wedges=lw.local), 1).to(
            torch.uint8)) > 0
    q = _quadrants(lw, layout, rings) if cfg.blind_spots else None
    reach_f, reach_b = bs.sweep_reach(wedges[0], tuple(blocked), w,
                                      num_rings, cfg, q=q)
    road = torch.cat([bs.flood_road(lay, reach_f, reach_b, w, bz)
                      for lay in wedges])
    if probe is not None:
        probe.update(w=w, reach_f=reach_f, reach_b=reach_b)
    return bs.road_labels(layout.label, road)


def _markers(lw, layout: RingLayout, rings: int, num_rings,
             counts_g: torch.Tensor, probe=None) -> torch.Tensor:
    """(361, 6) markers from the stacked sorted layout: K14 twice, each call
    one launch over the local wedges, with the global scan position g =
    ring * P_glob + wedge prefix + slot (counts_g: (size, R), all
    gathered), then the max/min/sum combines (the JAX _markers_sharded).
    The f32 sentinel F_NONE (3e38) of K14 is not the int32 maximum the JAX
    XLA branch uses for the same "no non-road point" (azimuth_parallel.py:
    624-626)."""
    loc = lw.local
    dev = layout.x.device
    prefix = lw.before(counts_g)
    p_glob = torch.amax(counts_g.sum(0, dtype=I32)) + 1
    goff = (torch.arange(rings, dtype=I32, device=dev) * p_glob
            + prefix).to(I32)  # (local, R)
    st1 = marker_state(layout, num_rings, goff, wedges=loc)
    f = lw.pmin(st1[..., 0])
    st2 = marker_state(layout, num_rings, goff,
                       f_init=f.expand(loc, N_BINS), wedges=loc)
    if probe is not None:
        probe.update(layout=layout, num_rings=num_rings, g_offset=goff,
                     f_init=f)
    maxd_loc = st2[..., 1]
    maxd = lw.pmax(maxd_loc)
    at_max = (maxd_loc == maxd) & (maxd > 0)
    gstar = lw.pmin(torch.where(at_max, st2[..., 2], F_NONE))
    # One wedge holds each bin's winner (g positions differ across
    # wedges): its x, y, z, zeros elsewhere, summed in one psum.
    xyz = lw.psum(torch.where((at_max & (st2[..., 2] == gstar))[..., None],
                              st2[..., 3:6], 0.0))
    bins = torch.arange(N_BINS, dtype=F32, device=dev)
    return torch.stack([(maxd > 0).to(F32), xyz[:, 0], xyz[:, 1], xyz[:, 2],
                        (f < F_NONE).to(F32), bins], dim=1)


def _run(x, y, z, cfg: FilterConfig, dims: PipelineDims, lw,
         per_wedge: int, cap: int, probe=None) -> ScanResult:
    d, loc = lw.size, lw.local
    n = x.shape[0]
    rings = dims.rings
    dev = x.device
    iota = torch.arange(n, dtype=I32, device=dev)

    with _stage("sp_partition"):
        # On the whole scan, in input order (every rank alike): ROI, star
        # keys (K1) and the wedge of each point; rank within wedge (K5);
        # then the local wedges' streams by gather.
        valid0, fk0, rk0, _ = ingest.ingest_prep(x[None], y[None], z[None],
                                                 cfg, want_star_keys=True)
        valid0, fk0, rk0 = valid0[0], fk0[0], rk0[0]
        wedge = wedge_of(fk0, valid0, d)
        wpos, _ = group_positions(wedge, d + 1)
        fits = (wedge < d) & (wpos < per_wedge)
        part_overflow = torch.sum((wedge < d) & ~fits, dtype=I32)
        dst = torch.where(fits, wedge * per_wedge + wpos, d * per_wedge).long()
        idx_w = torch.full((d * per_wedge + 1,), -1, dtype=I32, device=dev)
        idx_w[dst] = iota
        idx_w = idx_w[lw.first * per_wedge:(lw.first + loc) * per_wedge]
        has = idx_w >= 0
        take = torch.clamp(idx_w, min=0).long()
        _, alpha0 = geometry.vertical_angles(x, y, z)

        def wedged(a, fill):
            return torch.where(has, a[take], fill).view(loc, per_wedge)

        xw, yw, zw = (wedged(a, 0.0).contiguous() for a in (x, y, z))
        valid_w = wedged(valid0, False)
        alpha_w = wedged(alpha0, 0.0)
        fk_w = torch.where(valid_w, wedged(fk0, STAR_REP), STAR_REP)
        rk_w = torch.where(valid_w, wedged(rk0, math.inf), math.inf)
        piece = lw.psum(valid_w.sum(1, dtype=I32))
        ok = piece >= MIN_POINTS
        if probe is not None:
            probe.update(rank_ids={d + 1: wedge})

    with _stage("sp_rings"):
        # The global greedy over the points that fit (K2, input order, on
        # every rank alike), then the local wedges' points binned against
        # its table (K3).
        angles, num_rings = ingest.discover_rings(
            alpha0[None], (valid0 & fits)[None], cfg.interval, rings)
        num_rings = num_rings[0]
        ring_w = ingest.assign_rings(
            alpha_w, valid_w, angles.expand(loc, rings).contiguous(),
            cfg.interval)

    star = torch.zeros((loc, per_wedge + 1), dtype=F32, device=dev)
    if cfg.star_shaped_method:
        if probe is not None:
            probe.update(star=(xw, yw, zw, valid_w, fk_w, rk_w))
        with _stage("sp_star"):
            for k in range(loc):  # K4 per wedge: beams never straddle
                hp = star_hits(xw[k], yw[k], zw[k], valid_w[k], cfg,
                               keys=(fk_w[k], rk_w[k]))
                star[k].index_fill_(
                    0, torch.where(hp > 0, hp - 1, per_wedge).long(),
                    float(LABEL_CURB))

    with _stage("sp_tensorize"):
        # Ring r of local wedge w is group w * rings + r of one K5 + K6
        # pass; the local point index (+1) and the star marks ride a
        # second K6 pass; d2, alpha and the ring maxima come from one
        # ring_geometry launch.
        group = torch.where(ring_w < rings,
                            torch.arange(loc, device=dev)[:, None] * rings
                            + ring_w, loc * rings).to(I32).reshape(-1)
        pos, counts_all = group_positions(group, loc * rings + 1)
        if probe is not None:
            probe["rank_ids"][loc * rings + 1] = group
        lx, ly, lz, overflow = group_place(
            group, pos, counts_all,
            (xw.reshape(-1), yw.reshape(-1), zw.reshape(-1)), loc * rings,
            cap)
        pid1 = (torch.arange(per_wedge, device=dev, dtype=F32) + 1).expand(
            loc, per_wedge).reshape(-1)
        lab = star[:, :per_wedge].reshape(-1)
        lpid, llab, _ = group_place(group, pos, counts_all, (pid1, lab),
                                    loc * rings, cap)
        counts = torch.clamp(counts_all[:loc * rings], max=cap)
        g = geometry.ring_geometry(lx, ly, counts, fills=False)
        layout = RingLayout(
            x=lx, y=ly, z=lz, d2=g.d2, alpha=g.alpha, label=llab.to(I32),
            pid=lpid.to(I32) - 1, counts=counts, overflow=overflow)
        max_dist = lw.pmax(g.max_distance.view(loc, rings))
        counts_g = lw.all_gather(layout.counts.view(loc, rings))

    if cfg.x_zero_method or cfg.z_zero_method:
        with _stage("sp_xz_zero"):
            _halo_stencils(lw, layout, rings, cfg, counts_g, probe)

    with _stage("sp_blind_spots"):
        layout = geometry.sort_by_azimuth(layout, carry_pid=True)
        layout = layout._replace(label=_blind_spots(
            lw, layout, rings, max_dist, num_rings, cfg, probe))

    with _stage("sp_markers"):
        markers = _markers(lw, layout, rings, num_rings, counts_g, probe)

    with _stage("sp_gather"):
        # Each rank writes its wedges' ring ids (through each point's
        # wedge slot) and labels (through each slot's point index) at the
        # points' input positions, packed as ring * 4 + label, into zeros;
        # one psum joins the ranks' (a point sits in one wedge).
        row_wedge = torch.arange(loc * rings, device=dev)[:, None] // rings
        pid = layout.pid
        src = torch.where(pid >= 0, idx_w[torch.clamp(
            row_wedge * per_wedge + pid, 0, loc * per_wedge - 1)], n).long()
        # Two plain scatters: their only repeated index is the dump slot n
        # (an accumulating scatter serialises the many writes there).
        lab = torch.zeros((n + 1,), dtype=I32, device=dev)
        lab[src.reshape(-1)] = torch.where(pid >= 0, layout.label,
                                           0).reshape(-1)
        ring4 = torch.zeros((n + 1,), dtype=I32, device=dev)
        ring4[torch.where(has, idx_w, n).long()] = ring_w.reshape(-1) * 4
        packed = lw.psum((lab + ring4)[None, :n])
        roi = valid0 & fits
        ring_id = torch.where(roi, packed >> 2, rings)
        return ScanResult(
            ok=ok, roi=roi & ok,
            labels=torch.where(ok, packed & 3, 0).to(torch.int8),
            ring_id=ring_id.to(I32), num_rings=num_rings,
            counts=counts_g.sum(0, dtype=I32),
            max_distance=max_dist,
            markers=torch.where(ok, markers, 0.0),
            overflow=part_overflow + lw.psum(overflow[None]),
            star_overflow=torch.zeros((), dtype=I32, device=dev),
            probably_road=((ring_id == int(cfg.probably_road_ring))
                           & (ring_id < rings) & ok))


def rank_device(device=None) -> torch.device:
    """The device of this rank's wedges: ``device=None`` means cuda:<rank
    % card count> (pipeline.target_device's rules otherwise: without a
    card that raises unless "cpu" is asked for)."""
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda",
                              dist.get_rank() % torch.cuda.device_count())
    return target_device(device)


def make_azimuth_pipeline(n_wedges: int, cfg: FilterConfig,
                          dims: PipelineDims, wedge_slack: float = 1.5,
                          device=None, group=None):
    """``run(pts, cfg=None, layout="rows", probe=None)`` -> ScanResult for
    ONE padded scan of dims.max_points points, cut into ``n_wedges``
    azimuth wedges of max_points // n_wedges points each: (N, >=3) rows
    or, with ``layout="planar"``, (3, N) planes.  The result has the JAX SP
    path's fields and semantics, per input point.  ``cfg`` passed to run
    replaces the configuration for that call.

    ``group=None``: every wedge on one device (LocalWedges); ``device`` as
    for pipeline.process_scan: "cuda" unless "cpu" is asked for.  There
    ``run`` is compiled, as pipeline.process_scan_jit is: one CUDA graph of
    the whole SP run per key (static half of cfg, layout, input shape and
    dtype, device), captured on the key's first call after one eager run
    and replayed after the input is copied into the entry's buffer;
    ``run.entries`` holds the run's entries (each with its ``stats``), and
    each capture counts in pipeline.CAPTURE_COUNTS["sp"].  A change of the
    dynamic half of cfg (config.DynConfig) is one device copy into the
    entry's parameter buffer, no new capture.  A failed capture raises.
    The outputs are new tensors.  On the CPU (``device="cpu"``) the entries
    keep the same cache and counts and run the plain twins on their
    buffer.  ``run.eager`` (same arguments) runs the stages op by op from
    Python, as does ``run`` with a ``probe``: a probe reads intermediates
    that a replay does not keep.  While a torch profiler records, a call
    of ``run`` sits in an ``urf::entry.sp`` range and replays the entry's
    traced variant (pipeline._Compiled; utils.profiling), which holds the
    same collectives in the same order as the plain graph.

    With a torch.distributed process group, the wedges are spread over its
    ranks, n_wedges // world each (RankWedges, ``run.wedges``, with its
    ``census`` of the last run's collectives): every rank calls run on the
    same whole scan, in step, and every rank gets the whole result.
    ``device`` then defaults to cuda:<rank % card count>, and the group's
    backend must take tensors there (NCCL with a card per rank; gloo on
    the CPU or for ranks that share a card).  Which groups compile is
    decided here, from the group's backend for CUDA tensors, never from a
    failed capture: on an NCCL group ``run`` is compiled as on one card,
    each rank's graph holding its whole run with every all_gather and
    all_reduce of it (captured after one eager run, which really
    communicates and creates the communicator, so every rank meets a new
    key on the same call: the key holds only values alike on every rank,
    and the device); a failed capture raises there too.  On the CPU, over
    any group, the entries run the plain twins as above.  Over a gloo
    group on a card ``run`` is ``run.eager`` and ``run.entries`` stays
    empty: gloo stages each collective through host memory, which no
    graph can hold.  After every call, eager, a CPU entry or a replay,
    ``run.wedges.census`` holds that call's collectives (a replay's are
    those its capture recorded).  Raises ValueError where n_wedges does
    not divide 360 (star beams may not straddle wedges) or the group's
    size does not divide n_wedges.

    A dict passed as ``probe`` receives the kernels' (local) wedge inputs
    of that call: the ids of the two K5 calls ("rank_ids", {groups: ids}),
    the star search's (local, N / D) wedge streams with the star search on
    ("star": x, y, z, valid, fk, r_key; wedge k is star_hits(x[k], y[k],
    z[k], valid[k], cfg, (fk[k], r_key[k]))), K7's inputs ("halo": the
    stacked layout before the stencils and fused_xz_zero_halo's left,
    right, prefix and total), the stacked sorted layout after the flood
    fill ("layout", "num_rings"), the window widths and reach of K12 ("w",
    "reach_f", "reach_b") and K14's per-wedge offsets and global floor
    ("g_offset" (local, R), "f_init").

    ``wedge_slack`` over-provisions each wedge's ring slots beyond the
    uniform share ring_capacity / n_wedges (rounded up to 64, capped at
    ring_capacity), for the azimuth-density skew of real sensors.  Raises
    ValueError where the markers' f32 scan positions could pass 2^24:
    dims.rings x (min(max_points, n_wedges x slots per wedge) + 1) > 2^24."""
    if 360 % n_wedges != 0:
        raise ValueError(f"{n_wedges} wedges must divide 360 (star beams "
                         "may not straddle wedges)")
    if group is None:
        lw = LocalWedges(n_wedges)
    else:
        lw = RankWedges(n_wedges, group)
        device = rank_device(device)
    n = dims.max_points
    per_wedge = n // n_wedges
    cap = min(dims.ring_capacity,
              -64 * (-int(dims.ring_capacity // n_wedges * wedge_slack)
                     // 64))
    if dims.rings > ingest.MAX_RINGS:
        raise ValueError(f"at most {ingest.MAX_RINGS} rings, got "
                         f"{dims.rings}")
    # K14 carries the global scan position g = ring * P_glob + prefix + slot
    # in f32 (_markers), with P_glob at most min(N, n_wedges * cap) + 1: g
    # must stay below 2^24 to be exact.
    g_end = dims.rings * (min(n, n_wedges * cap) + 1)
    if g_end > 1 << 24:
        raise ValueError(
            f"scan positions up to {g_end} ({dims.rings} rings x "
            f"(min({n}, {n_wedges} wedges x {cap} slots) + 1)) are not "
            f"f32-exact; lower wedge_slack or ring_capacity")

    def checked(pts: torch.Tensor, layout: str):
        x, y, z, m = geometry.xyz_of(pts, layout)
        if m != n:
            raise ValueError(f"expected {n} points (dims.max_points), got "
                             f"{m}")
        if x.dtype != F32:
            raise TypeError(f"points must be float32, got {x.dtype}")
        return x, y, z

    def eager(pts, cfg_now: FilterConfig | None = None,
              layout: str = "rows", probe: dict | None = None
              ) -> ScanResult:
        x, y, z = checked(on_device(pts, device), layout)
        lw.census.clear()
        # The kernels and the glue read the dynamic parameters from the
        # configuration's cached buffer on the card (K4, K7's SP entry,
        # K8, K12 among them).
        return _run(x, y, z, device_config(
            cfg if cfg_now is None else cfg_now, x.device), dims, lw,
            per_wedge, cap, probe)

    def body(pts, bound_cfg, dims_, layout):
        """The compiled entry's stages, on its input buffer under its
        bound configuration."""
        lw.census.clear()
        return _run(*checked(pts, layout), bound_cfg, dims_, lw, per_wedge,
                    cap)

    entries: dict = {}
    censuses: dict = {}  # a captured entry -> its capture's census

    def run(pts, cfg_now: FilterConfig | None = None, layout: str = "rows",
            probe: dict | None = None) -> ScanResult:
        if probe is not None:
            return eager(pts, cfg_now, layout, probe)
        call = profiling.entry_call("sp")  # None unless a profiler records
        with profiling.entry_span("sp", call):
            pts = torch.as_tensor(pts)
            checked(pts, layout)
            entry, pts, dyn = compiled_entry(
                entries, "sp", body, pts, cfg if cfg_now is None else cfg_now,
                dims, layout, device)
            if entry.graph is None:  # the CPU: the body runs, and counts
                return entry(pts, dyn, call)
            # A replay runs no Python, so its collectives count nothing: the
            # census is the capture's, which the body left in lw.census.
            if entry not in censuses:
                censuses[entry] = _copy(lw.census)
            out = entry(pts, dyn, call)
            lw.census = _copy(censuses[entry])
            return out

    if group is not None and not _compiles(group, device):
        run = eager
    run.eager = eager
    run.entries = entries
    run.wedges = lw
    return run


def _copy(census: dict) -> dict:
    return {k: dict(v) for k, v in census.items()}


def _compiles(group, device: torch.device) -> bool:
    """Whether the SP run over ``group`` on ``device`` goes through the
    compiled entries: on the CPU always (the plain twins); on a card
    where the group's backend for CUDA tensors is NCCL, whose collectives
    a CUDA graph can hold, and not gloo's, which stage through the
    host."""
    # The backend reads "nccl", "gloo", or per device "cpu:gloo,cuda:nccl".
    return device.type == "cpu" or "nccl" in str(dist.get_backend(group))
