"""Star-shaped roadside search (reference: star_shaped_search.cpp:32-181).

Port of urban_road_filter_tpu/ops/star.py:star_hits.  Each ROI point goes
to one of 360 azimuth beams (optionally narrowed to the beam's rectangle);
each beam is walked in the order of a stable sort by radius (ties in input
order) and marks at most one point, the first whose slope trips a
threshold.  The marks reach the (ring, slot) layout through a 360-element
scatter (``star_labels``).

On the card the whole search is one kernel from the unsorted keys (K4,
``star_search``, csrc/star.cu: partition by beam without a sort, sort each
beam's bucket in shared memory, walk), over one scan or a batch of scans
(a leading lane axis: one launch, each lane's hits its own, as the JAX
package's batch runs the search under vmap).  Its plain version is the JAX
package's form: one stable (beam, radius, input order) sort of the streams
(``beam_streams``) and the walk along each beam's segment
(``star_walk_plain``); it is the CPU path and the kernel's yardstick.

The walk keeps the reference's sequential running mean and mean absolute
deviation, rounded in its order, where the JAX package used segmented
prefix sums: the CUDA kernel and the plain walk here repeat the numpy
oracle's ``_beam_walk`` operation for operation.  The
sector and radius keys come from the ingest kernel K1 (ops/ingest.py),
whose azimuth is the float64 atan2 rounded once to float32, as the C++ and
the oracle compute it.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from urban_road_filter_torch.config import FilterConfig, device_config
from urban_road_filter_torch.constants import (
    LABEL_CURB, STAR_REP, beam_tables)
from urban_road_filter_torch import _build
from urban_road_filter_torch.ops.geometry import F32, I32
from urban_road_filter_torch.ops.ingest import ingest_prep
from urban_road_filter_torch.ops.numerics import param

_beam_tables: dict = {}  # device -> the beam tables there


def _tables_on(device):
    """The beam rectangle tables on ``device``, copied there once (from
    pinned memory on the card, without blocking the host), so a scan makes
    no host-to-device copy and a graph capture can replay them."""
    hit = _beam_tables.get(device)
    if hit is None:
        host = [torch.from_numpy(np.asarray(t)) for t in beam_tables()]
        if device.type == "cuda":
            host = [t.pin_memory() for t in host]
        hit = (host, [t.to(device, non_blocking=True) for t in host])
        _beam_tables[device] = hit
    return hit[1]


def _rect(x, y, f):
    """Beam-rectangle membership (star_shaped_search.cpp:73-107), strict <,
    per point on its beam f."""
    yx_t, d_t, o_t = _tables_on(x.device)
    yx, d, o = yx_t[f], d_t[f], o_t[f]
    c = d * torch.where(yx, y, x)
    coord = torch.where(yx, x, y)
    return ((c - o) < coord) & (coord < (c + o))


def _star_keys(x, y, z, valid, cfg: FilterConfig, keys=None):
    """(fk, r_key) of one scan ((N,) streams) or a batch ((B, N)): ``keys``
    from the ingest kernel K1 (ops.ingest.ingest_prep), which already sends
    the points outside the ROI to the sink, or, without it, K1 run here on
    the scans with the points outside ``valid`` sent to the sink; then,
    with cfg.starbeam_filter, the points outside their beam's rectangle
    sent to the sink too (PyTorch glue)."""
    if keys is None:
        one = x.ndim == 1
        _, fk, r_key, _ = ingest_prep(
            *(t[None] if one else t for t in (x, y, z)), cfg)
        fk = torch.where(valid, fk[0] if one else fk, STAR_REP)
        r_key = torch.where(valid, r_key[0] if one else r_key, math.inf)
    else:
        fk, r_key = keys
    if cfg.starbeam_filter:
        # Sink points index the tables at beam 0; both branches keep them.
        rect = _rect(x, y, torch.where(fk < STAR_REP, fk, 0).long())
        fk = torch.where(rect, fk, STAR_REP)
        r_key = torch.where(rect, r_key, math.inf)
    return fk, r_key


def beam_order(fk, r_key, z):
    """The four beam-sorted streams (beam, radius, z, point index), (N,)
    each, of unsorted keys: one stable sort by (beam, radius, input order)
    as two stable torch.sorts; the sink (beam STAR_REP) sorts last."""
    order = torch.sort(r_key, stable=True).indices
    order = order[torch.sort(fk[order], stable=True).indices]
    return fk[order], r_key[order], z[order], order.to(I32)


def beam_streams(x, y, z, valid, cfg: FilterConfig, keys=None):
    """beam_order of one scan's star keys (``keys`` as for star_hits):
    beam STAR_REP (the sink, sorted last) for points outside the ROI or
    their beam's rectangle."""
    return beam_order(*_star_keys(x, y, z, valid, cfg, keys), z)


def _walk_params(cfg: FilterConfig):
    """(slope_param, kdev, kdist, dmin) as the plain walk uses them: 0-d
    tensors of a bound configuration (config.device_config), or host
    values."""
    dmin = cfg.dmin_param
    return (param(cfg.slope_param), param(cfg.kdev_param),
            param(cfg.kdist_param),
            dmin if isinstance(dmin, torch.Tensor) else int(dmin))


def star_walk_plain(fk_s, r_s, z_s, pid_s, cfg: FilterConfig):
    """The reference walk on all 360 beams at once, one walk step per
    iteration, each float operation as in oracle.reference._beam_walk."""
    slope_param, kdev, kdist, dmin = _walk_params(cfg)
    dev = fk_s.device
    beams = torch.arange(STAR_REP, dtype=I32, device=dev)
    start = torch.searchsorted(fk_s, beams)
    length = torch.searchsorted(fk_s, beams, right=True) - start
    steps = int(length.max()) if fk_s.numel() else 0
    hit = torch.zeros((STAR_REP,), dtype=I32, device=dev)
    if steps < 2:
        return hit
    col = torch.arange(steps, device=dev)
    inside = col[None, :] < length[:, None]
    at = torch.where(inside, start[:, None] + col[None, :], 0)
    rs, zs, pids = r_s[at], z_s[at], pid_s[at]
    zero = torch.zeros((STAR_REP,), dtype=F32, device=dev)
    avg, devs, nan_count = zero, zero, zero
    done = torch.zeros((STAR_REP,), dtype=torch.bool, device=dev)
    bx, by = rs[:, 0], zs[:, 0]
    for i in range(1, steps):
        live = inside[:, i] & ~done
        ax, ay, bx, by = bx, by, rs[:, i], zs[:, i]
        slp = (by - ay) / (bx - ax)
        skip = torch.isnan(slp)
        nan_count = torch.where(skip, nan_count + 1.0, nan_count)
        m = torch.full_like(zero, float(i)) - nan_count
        inv_m = torch.reciprocal(m)
        avg = torch.where(skip, avg, ((avg * (m - 1.0)) + slp) * inv_m)
        devs = torch.where(
            skip, devs, ((devs * (m - 1.0)) + torch.abs(slp - avg)) * inv_m)
        lhs = (slp * slp - avg * avg) * kdev * ((bx - ax) * kdist)
        trip = live & ((slp > slope_param) | ((i > dmin) & (lhs > devs)))
        hit = torch.where(trip, pids[:, i] + 1, hit)
        done = done | trip
    return hit


def star_search_plain(fk, r_key, z, cfg: FilterConfig) -> torch.Tensor:
    """The plain version of K4: beam_order, then star_walk_plain, per
    lane of a batch."""
    if fk.ndim == 2:
        return torch.stack([star_search_plain(*lane, cfg)
                            for lane in zip(fk, r_key, z)])
    return star_walk_plain(*beam_order(fk, r_key, z), cfg)


@functools.lru_cache(maxsize=64)
def _scratch_bytes(lanes: int, n: int, dev) -> int:
    """The scratch of one K4 launch over lanes x n points on ``dev``
    (csrc/star.cu, urf_star_scratch_bytes: it depends on the co-resident
    block count), asked once per shape and device."""
    lib = _build.library()
    out = ctypes.c_longlong(0)
    with torch.cuda.device(dev):
        err = lib.urf_star_scratch_bytes(lanes, n, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"star_walk: CUDA error {err}: "
                           f"{lib.urf_error_string(err).decode()}")
    return out.value


def star_search(fk, r_key, z, cfg: FilterConfig) -> torch.Tensor:
    """(360,) int32 hp: hp[b] = 1 + index of beam b's first triggering
    point, 0 where none, each beam walked in the order of a stable sort by
    r_key (K4).  fk (N,) int32 beams (STAR_REP = the sink; anything outside
    0..359 is skipped), r_key (N,) f32, z (N,) f32 (any stride on the
    card).  With a leading lane axis (fk, r_key, z (B, N); z any strides on
    the card) hp is (B, 360), lane b the search of lane b, from one
    launch."""
    if _build.on_cpu(fk):
        return star_search_plain(fk, r_key, z, cfg)
    one = fk.ndim == 1
    if one:
        fk, r_key, z = fk[None], r_key[None], z[None]
    b, n = fk.shape
    dev = fk.device
    _build.check(fk, "fk", I32, (b, n), dev)
    _build.check(r_key, "r_key", F32, (b, n), dev)
    _build.check(z, "z", F32, (b, n), dev, contiguous=False)
    if n >= 1 << 24:
        raise ValueError(f"the star search counts walk steps as f32: "
                         f"n < 2^24, got {n}")
    cfg = device_config(cfg, dev)
    # Per partition unit a region of keys and (r, z), 16 bytes an entry,
    # and the (units, 360) run table.
    scratch = torch.empty((-(-_scratch_bytes(b, n, dev) // 8),),
                          dtype=torch.int64, device=dev)
    hp = torch.empty((b, STAR_REP), dtype=I32, device=dev)
    _build.launch("star_walk", "urf_star_search", dev, _build.ptr(fk),
                  _build.ptr(r_key), _build.ptr(z), z.stride(1), z.stride(0),
                  n, b,
                  *(_build.ptr(getattr(cfg, k)) for k in (
                      "slope_param", "kdev_param", "kdist_param",
                      "dmin_param")),
                  _build.ptr(scratch), _build.ptr(hp))
    return hp[0] if one else hp


def star_hits(x, y, z, valid, cfg: FilterConfig, keys=None) -> torch.Tensor:
    """(360,) int32 hp of the star search over one scan's points ((N,)
    streams), or (B, 360) over a batch ((B, N)): ``keys`` is the (fk, r_key)
    of the same scans from the ingest kernel K1, or None to run K1 here
    (the points outside ``valid`` go to the sink)."""
    return star_search(*_star_keys(x, y, z, valid, cfg, keys), z, cfg)


def star_labels(hp, ring_id, pos, label) -> torch.Tensor:
    """LABEL_CURB at each hit point's (ring, slot) of ``label``, the
    layout's (rings, cap) int32 plane of zeros, in place; returns it.  A
    hit dropped at binning or by capacity lands nowhere
    (pipeline.py:141-150 of the JAX package): it takes the max with 0 at
    slot 0.  With a leading lane axis (hp (B, 360), ring_id and pos (B, N),
    label (B, rings, cap)): each lane's hits in its own table, one scatter
    for the batch."""
    rings, cap = label.shape[-2:]
    n = ring_id.shape[-1]
    lead = hp.shape[:-1]
    plane = rings * cap
    h = torch.clamp(hp - 1, 0, n - 1).long()
    ring = torch.gather(ring_id, -1, h).long()
    slot = torch.gather(pos, -1, h).long()
    landed = (hp > 0) & (ring < rings) & (slot >= 0) & (slot < cap)
    lanes = math.prod(lead)
    at = torch.where(landed, ring * cap + slot, 0)
    if lanes > 1:  # lane b's table starts at b * plane
        at = at + torch.arange(lanes, device=hp.device).view(
            *lead, 1) * plane
    label.view(-1).scatter_reduce_(0, at.reshape(-1),
                                   (landed.to(I32) * LABEL_CURB).reshape(-1),
                                   "amax")  # no host value copied
    return label
