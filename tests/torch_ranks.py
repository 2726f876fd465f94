"""The ranks' side of tests/test_torch_sp_ranks.py: one process per rank of
a gloo group on the CPU, started with torch.multiprocessing's spawn
method.  It imports the port and never JAX, so that the ranks run as the
port's users run them.

``main`` joins the group through a FileStore, runs every job below in the
same order on every rank (the collectives pair up in that order) and puts
``(rank, results)`` on the queue, numpy arrays and plain values only; a
failure puts its traceback under "error".  The swaps and the host-read
check below serve tests/test_torch_sp_jit.py too.
"""

from __future__ import annotations

import datetime
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from urban_road_filter_torch import FilterConfig, PipelineDims, pad_scan
from urban_road_filter_torch import pipeline as pl
from urban_road_filter_torch.convert import to_numpy
from urban_road_filter_torch.io import SCENES, make_scan
from urban_road_filter_torch.io.replay import (
    ReplayHarness, follow, pcd_dir_source)
from urban_road_filter_torch.parallel.azimuth_parallel import (
    RankWedges, _compiles, azimuth_sorted, make_azimuth_pipeline)

WORLD = 4
TIMEOUT_S = 120  # a collective that waits longer ends its rank
DIMS = PipelineDims(max_points=8192, rings=64, ring_capacity=1024,
                    beam_capacity=256)  # tests/test_torch_sp.py's
HDIMS = PipelineDims(max_points=16384, rings=64, ring_capacity=1024,
                     beam_capacity=256)  # the PCD fixtures'
CONFIGS = {"star": {}, "star_off": {"star_shaped_method": False},
           "stencils_off": {"x_zero_method": False, "z_zero_method": False}}
# tests/test_torch_sp.py's scans (16 rings x 384 azimuths), and one whose
# rings hold more ROI points (up to 769) than a rank's wedges have ring
# slots (384), so that the stencils' newY ladder runs past them; its
# wedges overflow (699 points).
SCANS = {"two_curbs": ("two_curbs", 16, 384),
         "blind_spot": ("blind_spot", 16, 384),
         "two_curbs_dense": ("two_curbs", 4, 2048)}
SP_CASES = [(scene, c) for scene in ("two_curbs", "blind_spot")
            for c in ("star", "star_off")] + [
    ("two_curbs", "stencils_off"), ("two_curbs_dense", "star")]
WEDGES = (8, 4)  # 2 and 1 wedges a rank
SWAP_AT = 1  # the harness's scan after which beam_zone becomes 50
# One new value for each of the 15 dynamic fields (config.DynConfig; cos_x,
# cos_z and slope_param through the three angles), for the port's tests: a
# copy that imports no JAX of the JAX tests' tests/test_config_dynamic.py
# DYNAMIC_SWAPS, which tests/test_torch_sp_ranks.py pins it to.
DYNAMIC_SWAPS = dict(
    interval=0.3, curb_height=0.11, beam_zone=42.5,
    min_x=1.0, max_x=25.0, min_y=-8.0, max_y=8.0, min_z=-2.8, max_z=-1.2,
    cylinder_deg_x=140.0, cylinder_deg_z=130.0, curb_slope_deg=45.0,
    kdev_param=1.5, kdist_param=3.0, dmin_param=8,
)
SWAPS = {**{k: {k: v} for k, v in DYNAMIC_SWAPS.items()},
         "all": dict(DYNAMIC_SWAPS)}
STATIC_CHANGE = {"blind_spots": False}
# The ops that read a tensor's value back to the host (.item(), float(),
# int(), bool() of a tensor, and the data-dependent shapes).
HOST_READS = ("aten._local_scalar_dense", "aten.nonzero",
              "aten.masked_select", "aten._unique", "aten.unique")
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


def config(name: str) -> FilterConfig:
    return FilterConfig(**CONFIGS[name])


def sp_raw(name: str) -> np.ndarray:
    """The azimuth-sorted scan of SCANS[name]."""
    scene, n_rings, n_azimuth = SCANS[name]
    return azimuth_sorted(make_scan(SCENES[scene](), n_rings=n_rings,
                                    n_azimuth=n_azimuth, seed=11))


def sp_scan(scene: str) -> np.ndarray:
    return pad_scan(sp_raw(scene), DIMS.max_points)


def sp_planar(scene: str) -> np.ndarray:
    """sp_scan's (3, N) planes."""
    return np.ascontiguousarray(sp_scan(scene)[:, :3].T)


def one_wedge_scan() -> np.ndarray:
    """tests/test_torch_sp.py::test_overflow_when_all_points_in_one_wedge's
    scan: a quarter of the points, all at one azimuth."""
    rng = np.random.default_rng(3)
    n = DIMS.max_points
    m = n // 4
    pts = np.zeros((n, 4), np.float32)
    pts[:m, 0] = rng.uniform(5.0, 9.0, m)
    pts[:m, 1] = -pts[:m, 0] * np.float32(np.tan(np.radians(12.0)))
    pts[:m, 2] = -1.2
    return pts


def method_inputs(size: int) -> dict:
    """Seeded (size, ...) stacks for the wedge methods: floats with +-inf
    and small integers (whose sums are exact in any order), int32 and a
    bool mask."""
    rng = np.random.default_rng(size)
    f = rng.integers(-1000, 1000, (size, 5, 3)).astype(np.float32)
    f[rng.random(f.shape) < 0.2] = np.inf
    f[rng.random(f.shape) < 0.2] = -np.inf
    return {"f": f, "i": rng.integers(-2**20, 2**20, (size, 7)).astype(
                np.int32),
            "b": rng.random((size, 6, 2)) < 0.5}


def methods(lw, ins: dict) -> dict:
    """Each wedge method of ``lw`` on its wedges' rows of the stacks (the
    stacks themselves for a LocalWedges); ``before`` takes the gathered
    stack.  Returns numpy arrays by name."""
    sl = slice(lw.first, lw.first + lw.local)
    t = {k: torch.from_numpy(v[sl]) for k, v in ins.items()}
    out = {"all_gather_f": lw.all_gather(t["f"]),
           "all_gather_i": lw.all_gather(t["i"]),
           "all_gather_b": lw.all_gather(t["b"]),
           "psum_i": lw.psum(t["i"]), "psum_f": lw.psum(
               torch.nan_to_num(t["f"], posinf=7.0, neginf=-7.0)),
           "pmax_f": lw.pmax(t["f"]), "pmin_f": lw.pmin(t["f"]),
           "pmax_i": lw.pmax(t["i"]), "pmin_i": lw.pmin(t["i"]),
           "pmax_b": lw.pmax(t["b"].to(torch.uint8)),
           "index": lw.index(), "all_index": lw.all_index(),
           "before": lw.before(torch.from_numpy(ins["i"]))}
    return {k: v.numpy() for k, v in out.items()}


def gather_forms(lw, ins: dict) -> dict:
    """lw.all_gather (one tensor) beside the list form of dist.all_gather
    and a concatenation, on this rank's rows of each stack: {name: (one
    tensor, list form)} as numpy arrays."""
    sl = slice(lw.first, lw.first + lw.local)
    out = {}
    for k, v in ins.items():
        t = torch.from_numpy(v[sl])
        wire = RankWedges._wire(t)
        parts = [torch.empty_like(wire) for _ in range(lw.world)]
        dist.all_gather(parts, wire, group=lw.group)
        out[k] = (lw.all_gather(t).numpy(), torch.cat(parts).numpy())
    return out


def census(run) -> dict:
    return {k: dict(v) for k, v in run.wedges.census.items()}


def calls(run, scene: str) -> dict:
    """The compiled run against run.eager on one SP case, rows and planar:
    {(mode, layout): (each call's fields, the census left after it)}."""
    out = {}
    for layout, pts in (("rows", sp_scan(scene)),
                        ("planar", sp_planar(scene))):
        for mode, fn in (("compiled", run), ("eager", run.eager)):
            out[mode, layout] = (tuple(to_numpy(fn(pts, layout=layout))),
                                 census(run))
    return out


def swaps(run) -> dict:
    """Each dynamic swap (and all at once) on the run's warm rows entry,
    then one static change: {swap: (compiled fields, eager fields, new
    captures, new entries)}."""
    pts = sp_scan("two_curbs")
    run(pts)
    out = {}
    for name, kw in {**SWAPS, "static": STATIC_CHANGE}.items():
        cfg = FilterConfig(**kw)
        before, entries = pl.CAPTURE_COUNTS["sp"], len(run.entries)
        got = tuple(to_numpy(run(pts, cfg)))
        out[name] = (got, tuple(to_numpy(run.eager(pts, cfg))),
                     pl.CAPTURE_COUNTS["sp"] - before,
                     len(run.entries) - entries)
    return out


class HostReads(TorchDispatchMode):
    """Records each host read of a tensor value with the port's function
    that made it."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith(HOST_READS):
            frames = [f.name for f in traceback.extract_stack()
                      if "urban_road_filter_torch" in f.filename]
            self.seen.append((str(func), frames))
        return func(*args, **(kwargs or {}))


def host_reads(run, star: bool) -> dict:
    """{mode: [(op, the port's frames)]}: the host reads of one warm
    compiled call and one eager call of the run, under every dynamic
    swap at once (``star``: the run's star_shaped_method)."""
    pts = torch.from_numpy(sp_scan("two_curbs"))
    cfg = FilterConfig(star_shaped_method=star, **DYNAMIC_SWAPS)
    out = {}
    for mode, fn in (("compiled", run), ("eager", run.eager)):
        fn(pts, cfg)
        with HostReads() as seen:
            fn(pts, cfg)
        out[mode] = seen.seen
    return out


def stencil_frame(run) -> tuple:
    """The global ring positions of the stencils and the markers in one
    run of the two_curbs scan: K7's prefix and total, K14's g_offset."""
    probe = {}
    run(sp_scan("two_curbs"), probe=probe)
    _, _, _, prefix, total = probe["halo"]
    return prefix.numpy(), total.numpy(), probe["g_offset"].numpy()


def harness_scans() -> list:
    """The three PCD fixtures and three two_curbs scans."""
    return list(pcd_dir_source(FIXTURES)) + [
        azimuth_sorted(make_scan(SCENES["two_curbs"](), n_rings=16,
                                 n_azimuth=384, seed=s)) for s in (0, 1, 2)]


def run_harness(group=None, swap: bool = True) -> list:
    """The SP harness (4 wedges) on harness_scans(), with beam_zone swapped
    to 50 after scan SWAP_AT through h.cfg (examples/demo_torch.py's hot
    swap): over the group's ranks (this is rank 0) or, without one, on one
    device.  Returns the published ScanOutputs."""
    outs: list = []
    h = ReplayHarness(cfg=FilterConfig(), dims=HDIMS, azimuth_shard=4,
                      device="cpu", group=group)

    def on_scan(o):
        outs.append(o)
        if swap and o.seq == SWAP_AT:
            h.cfg = h.cfg.replace(beam_zone=50.0)

    h.on_scan = on_scan
    try:
        h.run(iter(harness_scans()))
    finally:
        h.close()
    assert h.metrics.summary()["errors"] == 0, h.metrics.last_error
    return outs


def _jobs(rank: int, group) -> dict:
    out = {}
    for size in WEDGES:
        out[f"methods_{size}"] = methods(RankWedges(size, group),
                                         method_inputs(size))
    try:  # refused before any collective, on every rank alike
        RankWedges(8, group).psum(torch.zeros(3, dtype=torch.int64))
    except TypeError as e:
        out["int64_refused"] = str(e)
    for d in WEDGES:
        for scene, cname in SP_CASES:
            run = make_azimuth_pipeline(d, config(cname), DIMS,
                                        device="cpu", group=group)
            before = pl.CAPTURE_COUNTS["sp"]
            out["sp", d, scene, cname] = tuple(to_numpy(run(sp_scan(scene))))
            out["census", d, scene, cname] = {
                k: dict(v) for k, v in run.wedges.census.items()}
            out["calls", d, scene, cname] = calls(run, scene)
            out["captures", d, scene, cname] = (
                pl.CAPTURE_COUNTS["sp"] - before, len(run.entries))
            if d == 8 and scene == "two_curbs" and cname in ("star",
                                                             "star_off"):
                out["host_reads", cname] = host_reads(run, cname == "star")
                if cname == "star":
                    out["swaps"] = swaps(run)
    for size in WEDGES:
        out[f"gather_forms_{size}"] = gather_forms(RankWedges(size, group),
                                                   method_inputs(size))
    run = make_azimuth_pipeline(8, FilterConfig(), DIMS, device="cpu",
                                group=group)
    # On the CPU the group's run goes through the entries; a gloo group's
    # on a card would stay op by op.
    out["backend_compiles"] = (run is not run.eager, _compiles(
        group, torch.device("cpu")), _compiles(group, torch.device("cuda", 0)))
    out["overflow"] = tuple(to_numpy(run(one_wedge_scan())))
    out["frame"] = stencil_frame(run)
    for d in (6, 7):  # 6 % 4 ranks, 360 % 7
        try:
            make_azimuth_pipeline(d, FilterConfig(), DIMS, device="cpu",
                                  group=group)
        except ValueError as e:
            out["refused", d] = str(e)
    try:  # device=None: the card, and there is none
        make_azimuth_pipeline(8, FilterConfig(), DIMS, group=group)
    except RuntimeError as e:
        out["no_card"] = str(e)
    before = pl.CAPTURE_COUNTS["sp"]
    if rank == 0:
        out["harness"] = run_harness(group)
    else:
        out["followed"] = follow(FilterConfig(), HDIMS, 4, group,
                                 device="cpu")
    out["harness_captures"] = pl.CAPTURE_COUNTS["sp"] - before
    out["jax_free"] = not [m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "urban_road_filter_tpu")]
    return out


def main(rank: int, world: int, store_path: str, queue) -> None:
    torch.set_num_threads(1)  # several ranks share the CPU with pytest
    out = {}
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
        out = _jobs(rank, dist.group.WORLD)
    except Exception:  # noqa: BLE001 -- reported to the test
        out["error"] = traceback.format_exc()
    finally:
        queue.put((rank, out))
        if dist.is_initialized():
            dist.destroy_process_group()

