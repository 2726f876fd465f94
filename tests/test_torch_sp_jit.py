"""The port's compiled azimuth-sharded (SP) run on the CPU: the counterpart
of tests/test_azimuth_parallel.py's hot-swap test.

make_azimuth_pipeline(n, cfg, dims) with every wedge on one device returns
a compiled run: one entry per (static half of the configuration, layout,
input shape and dtype, device) in the run's own cache, with a parameter
buffer of its own that the stages read (on the card a CUDA graph captured
once and replayed; here the plain twins on the same buffer).  Held here:

* the compiled run equal to ``run.eager`` on every field, two scenes with
  the star search on and off, rows and planar;
* the JAX hot swap: a = run(pts), b = run(pts, max_x=12), c = run(pts),
  each against the JAX make_azimuth_pipeline's on the 8-device CPU mesh
  (structural fields exact, labels and markers exact or within the classes
  of tests/test_torch_pipeline.py), b's ROI smaller, a == c, no capture;
* each of the 15 dynamic fields swapped, and all at once: equal to
  ``run.eager`` under the new configuration, no capture; a static change
  and a layout change one capture each; a second run its own cache;
* a probe runs the eager stages and fills the probe;
* the harness's SP mode on one device runs through the compiled entry,
  across a mid-stream swap, with the topics of ``run.eager``'s results;
* the SP glue reads no tensor value back to the host (what a CUDA-graph
  capture refuses, and what would bake a dynamic value into a graph):
  the only such reads are the plain star walk's step count, a CPU twin
  that on the card is K4.

On the card chip_smoke.py phase 10 and tests/test_torch_kernels_gpu.py run
the same through the graphs.
"""

import jax
import numpy as np
import pytest
import torch

from test_config_dynamic import STATIC_SWAPS
from test_torch_pipeline import (
    _assert_labels_vs_jax, _assert_markers_vs_jax, _envelope)
from torch_ranks import DYNAMIC_SWAPS, SWAPS, HostReads
from urban_road_filter_tpu.config import FilterConfig as JaxConfig
from urban_road_filter_tpu.config import PipelineDims as JaxDims
from urban_road_filter_tpu.io.synthetic import SCENES, make_scan
from urban_road_filter_tpu.oracle import run_oracle
from urban_road_filter_tpu.parallel.azimuth_parallel import (
    make_azimuth_pipeline as jax_sp)
from urban_road_filter_tpu.parallel.mesh import make_mesh
from urban_road_filter_torch import (
    FilterConfig, PipelineDims, pad_scan, pad_scan_planar)
from urban_road_filter_torch import pipeline as pl
from urban_road_filter_torch.convert import to_numpy
from urban_road_filter_torch.config import DynConfig
from urban_road_filter_torch.io.replay import ReplayHarness
from urban_road_filter_torch.parallel.azimuth_parallel import (
    azimuth_sorted, make_azimuth_pipeline)

torch.set_num_threads(1)  # tier-1 runs several pytest workers

DIMS = PipelineDims(max_points=8192, rings=64, ring_capacity=1024,
                    beam_capacity=256)
JAX_DIMS = JaxDims(**DIMS.__dict__)
CONFIGS = {"default": FilterConfig(),
           "star_off": FilterConfig(star_shaped_method=False)}
SCENE_NAMES = ("two_curbs", "blind_spot")
STRUCTURAL = ("ok", "roi", "num_rings", "ring_id", "counts", "overflow",
              "star_overflow", "probably_road")


def _scan(scene, seed=11):
    return azimuth_sorted(make_scan(SCENES[scene](), n_rings=16,
                                    n_azimuth=384, seed=seed))


def _same(got, want, what):
    assert type(got) is type(want), what
    for f, a, b in zip(got._fields, got, want):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert a.shape == b.shape and torch.equal(a, b), (what, f)


@pytest.fixture(scope="module")
def runs():
    """One compiled run per configuration, shared by the tests (their
    entries persist, as a caller's would)."""
    return {c: make_azimuth_pipeline(8, cfg, DIMS, device="cpu")
            for c, cfg in CONFIGS.items()}


@pytest.fixture(scope="module")
def pts():
    return torch.from_numpy(pad_scan(_scan("two_curbs"), DIMS.max_points))


@pytest.mark.parametrize("layout", ["rows", "planar"])
@pytest.mark.parametrize("cname", list(CONFIGS))
@pytest.mark.parametrize("scene", SCENE_NAMES)
def test_compiled_equals_eager(scene, cname, layout, runs):
    raw = _scan(scene)
    pts = torch.from_numpy(pad_scan(raw, DIMS.max_points) if layout == "rows"
                           else pad_scan_planar(raw, DIMS.max_points))
    run = runs[cname]
    got = run(pts, layout=layout)
    want = run.eager(pts, layout=layout)
    _same(got, want, f"{scene} {cname} {layout}")
    assert bool(got.ok) and int(got.overflow) == 0
    assert (got.labels == 1).sum() > 500 and got.markers[:, 0].sum() > 100
    keys = [k for k in run.entries if k[3] == layout]
    assert len(keys) == 1 and keys[0][0] == "sp"
    assert keys[0][1] == CONFIGS[cname].split()[0]


@pytest.fixture(scope="module")
def jax_swap():
    """tests/test_azimuth_parallel.py's hot swap, a, b (max_x=12), c, on
    the JAX make_azimuth_pipeline over the 8-device CPU mesh."""
    raw = _scan("two_curbs", seed=17)
    pts = pad_scan(raw, DIMS.max_points)
    cfg = JaxConfig()
    run = jax_sp(make_mesh(n_data=1, n_azimuth=8), cfg, JAX_DIMS)
    outs = [run(pts), run(pts, cfg.replace(max_x=12.0)), run(pts)]
    return raw, [jax.tree_util.tree_map(np.asarray, o) for o in outs]


def test_hot_swap_mirrors_jax(jax_swap):
    raw, want = jax_swap
    pts = pad_scan(raw, DIMS.max_points)
    cfg = FilterConfig()
    run = make_azimuth_pipeline(8, cfg, DIMS, device="cpu")
    a = run(pts)
    before = dict(pl.CAPTURE_COUNTS)
    b = run(pts, cfg.replace(max_x=12.0))
    c = run(pts)
    assert pl.CAPTURE_COUNTS == before and len(run.entries) == 1
    assert int(b.roi.sum()) < int(a.roi.sum())
    _same(c, a, "a vs c")
    for what, got, w, jcfg in (("a", a, want[0], JaxConfig()),
                               ("b", b, want[1], JaxConfig(max_x=12.0)),
                               ("c", c, want[2], JaxConfig())):
        got = to_numpy(got)
        for f in STRUCTURAL:
            np.testing.assert_array_equal(getattr(got, f), getattr(w, f),
                                          err_msg=f"{what} {f}")
        np.testing.assert_array_max_ulp(got.max_distance, w.max_distance,
                                        maxulp=1)
        orc = run_oracle(raw, jcfg)
        env_runs = _envelope(raw, jcfg)
        _assert_labels_vs_jax(got.labels, w.labels, raw, orc.roi_mask, orc,
                              env_runs, f"SP hot swap {what} labels")
        _assert_markers_vs_jax(got.markers, w.markers, orc, env_runs,
                               f"SP hot swap {what} markers")


@pytest.fixture(scope="module")
def warm(runs, pts):
    """The default run's rows entry, made once."""
    runs["default"](pts)


@pytest.mark.parametrize("swap", list(SWAPS))
def test_dynamic_swap_no_capture(swap, runs, pts, warm):
    """Each dynamic field swapped alone, and all at once, on the warm
    entry: the eager result under the new configuration, no capture."""
    assert len(DYNAMIC_SWAPS) == len(DynConfig._fields)
    run = runs["default"]
    before = dict(pl.CAPTURE_COUNTS)
    n_entries = len(run.entries)
    cfg = FilterConfig(**SWAPS[swap])
    _same(run(pts, cfg), run.eager(pts, cfg), swap)
    assert pl.CAPTURE_COUNTS == before and len(run.entries) == n_entries


@pytest.mark.parametrize("change", sorted(STATIC_SWAPS))
def test_static_change_captures_once(change, runs, pts, warm):
    run = runs["default"]
    before = pl.CAPTURE_COUNTS["sp"]
    n_entries = len(run.entries)
    cfg = FilterConfig(**{change: STATIC_SWAPS[change]})
    _same(run(pts, cfg), run.eager(pts, cfg), change)
    assert pl.CAPTURE_COUNTS["sp"] == before + 1, change
    assert len(run.entries) == n_entries + 1


def test_layout_change_captures_once(pts):
    run = make_azimuth_pipeline(8, FilterConfig(), DIMS, device="cpu")
    rows = run(pts)
    before = pl.CAPTURE_COUNTS["sp"]
    planar = pts[:, :3].T.contiguous()
    _same(run(planar, layout="planar"), rows, "planar vs rows")
    run(planar, FilterConfig(beam_zone=42.5), layout="planar")
    assert pl.CAPTURE_COUNTS["sp"] == before + 1
    assert sorted(k[3] for k in run.entries) == ["planar", "rows"]


def test_each_run_has_its_own_cache(runs, pts):
    runs["default"](pts)
    before = pl.CAPTURE_COUNTS["sp"]
    other = make_azimuth_pipeline(8, FilterConfig(), DIMS, device="cpu")
    _same(other(pts), runs["default"](pts), "a second run")
    assert pl.CAPTURE_COUNTS["sp"] == before + 1
    assert len(other.entries) == 1


def test_probe_runs_the_eager_stages(runs, pts):
    run = runs["default"]
    want = run(pts)
    before = dict(pl.CAPTURE_COUNTS)
    probe = {}
    _same(run(pts, probe=probe), want, "probed run")
    assert pl.CAPTURE_COUNTS == before
    assert set(probe) == {"rank_ids", "star", "halo", "layout", "num_rings",
                          "w", "reach_f", "reach_b", "g_offset", "f_init"}
    assert sorted(probe["rank_ids"]) == [9, 8 * DIMS.rings + 1]
    assert probe["star"][0].shape == (8, DIMS.max_points // 8)
    again = {}
    run.eager(pts, probe=again)
    assert set(again) == set(probe)


def test_harness_sp_mode_replays_the_compiled_run():
    """azimuth_shard=8 on one device: the harness makes one compiled
    entry, keeps it across the demo's beam_zone swap, and publishes the
    topics of run.eager's results under each scan's configuration."""
    scans = [_scan("two_curbs", seed=s) for s in (0, 1, 2)]
    got, cfgs = [], []

    def on_scan(out):
        got.append(out)
        cfgs.append(h.cfg)
        if out.seq == 0:
            h.cfg = h.cfg.replace(beam_zone=50.0)

    before = pl.CAPTURE_COUNTS["sp"]
    h = ReplayHarness(cfg=FilterConfig(), dims=DIMS, azimuth_shard=8,
                      device="cpu", on_scan=on_scan)
    s = h.run(iter(scans)).summary()
    assert s["errors"] == 0 and s["scans"] == 3, s
    assert pl.CAPTURE_COUNTS["sp"] == before + 1
    assert len(h._sp_run.entries) == 1
    ref = ReplayHarness(dims=DIMS, device="cpu")
    used = [FilterConfig(), FilterConfig(beam_zone=50.0),
            FilterConfig(beam_zone=50.0)]
    assert cfgs == used
    for k, (scan, o, cfg) in enumerate(zip(scans, got, used)):
        res = h._sp_run.eager(pad_scan_planar(scan, DIMS.max_points), cfg,
                              layout="planar")
        ref._seq = k
        want = ref._postprocess(scan, ref._fetch_outputs(res), 0.0)
        assert o.ok and want.ok and o.seq == want.seq == k
        for f in ("road", "curb", "roi", "road_probably"):
            a, b = getattr(o, f), getattr(want, f)
            assert a.shape == b.shape and np.array_equal(
                a.view(np.int32), b.view(np.int32)), (k, f)
        assert len(o.marker_strips) == len(want.marker_strips) > 0
        for u, v in zip(o.marker_strips, want.marker_strips):
            assert (u.id, u.color) == (v.id, v.color)
            assert np.array_equal(u.points, v.points)
    assert len(got[1].road) != len(got[0].road) or not np.array_equal(
        got[1].road, got[0].road)


@pytest.mark.parametrize("entry", ["compiled", "eager"])
@pytest.mark.parametrize("cname", list(CONFIGS))
def test_sp_glue_reads_nothing_back(cname, entry, runs, pts):
    run = runs[cname]
    call = run if entry == "compiled" else run.eager
    cfg = FilterConfig(star_shaped_method=CONFIGS[cname].star_shaped_method,
                       **DYNAMIC_SWAPS)
    call(pts, cfg)
    with HostReads() as mode:
        call(pts, cfg)
    glue = [(op, frames[-3:]) for op, frames in mode.seen
            if "star_walk_plain" not in frames]
    assert not glue, glue[:5]
    if not CONFIGS[cname].star_shaped_method:
        assert not mode.seen
