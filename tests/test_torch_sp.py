"""The port's azimuth-sharded (SP) path on the CPU: its eight wedges share one
device (LocalWedges), and the result is held against the JAX package's
make_azimuth_pipeline on the 8-device CPU mesh that tests/conftest.py sets
up, and against the port's own process_scan.

Scans are azimuth-sorted (the SP path's documented ordering assumption).
With the star search off every structural field of the JAX SP result must
match exactly (ok, roi, num_rings, ring_id, counts, overflow,
probably_road; max_distance to an ulp, since XLA's jitted CPU code may
fuse x*x + y*y); labels and markers exactly or within the classes of
tests/test_torch_pipeline.py (a one-ulp azimuth at an integer degree, or
the oracle's own ulp envelope).  With the star search on the port follows
the oracle's sequential walk where the JAX package's prefix sums differ on
about one beam in 360, so labels and markers are classified the same way.
Against its own process_scan on the sorted scan the port's SP result is
equal on every field.
"""

import math

import jax
import numpy as np
import pytest
import torch

from urban_road_filter_tpu.config import FilterConfig as JaxConfig
from urban_road_filter_tpu.config import PipelineDims
from urban_road_filter_tpu.io.synthetic import SCENES, make_scan
from urban_road_filter_tpu.oracle import run_oracle
from urban_road_filter_tpu.parallel.azimuth_parallel import (
    _wedge_of as jax_wedge_of)
from urban_road_filter_tpu.parallel.azimuth_parallel import (
    make_azimuth_pipeline as jax_sp)
from urban_road_filter_tpu.parallel.mesh import make_mesh
from urban_road_filter_tpu.utils.parity import device_parity_gate
from urban_road_filter_torch import (
    launch_counts, pad_scan, pad_scan_planar, process_scan,
    reset_launch_counts)
from urban_road_filter_torch.convert import filter_config, to_numpy
from urban_road_filter_torch.ops import ingest
from urban_road_filter_torch.parallel.azimuth_parallel import (
    azimuth_sorted, make_azimuth_pipeline, wedge_of)
from test_torch_pipeline import (
    _assert_labels_vs_jax, _assert_markers_vs_jax, _envelope)

torch.set_num_threads(1)  # tier-1 runs several pytest workers

DIMS = PipelineDims(max_points=8192, rings=64, ring_capacity=1024,
                    beam_capacity=256)
CONFIGS = {"star": JaxConfig(),
           "star_off": JaxConfig(star_shaped_method=False)}
CASES = [(scene, c) for scene in ("two_curbs", "blind_spot") for c in CONFIGS]


def _scan(scene):
    return azimuth_sorted(make_scan(SCENES[scene](), n_rings=16,
                                    n_azimuth=384, seed=11))


def _sp(cfg, pts, **kw):
    run = make_azimuth_pipeline(8, filter_config(cfg), DIMS, device="cpu")
    return to_numpy(run(pts, **kw))


@pytest.fixture(scope="module")
def jax_runs():
    """JAX make_azimuth_pipeline on every (scene, configuration): four runs
    of the 8-wedge shard_map on the CPU mesh."""
    mesh = make_mesh(n_data=1, n_azimuth=8)
    out = {}
    for scene, cname in CASES:
        pts = pad_scan(_scan(scene), DIMS.max_points)
        out[scene, cname] = jax.tree_util.tree_map(
            np.asarray, jax_sp(mesh, CONFIGS[cname], DIMS)(pts))
    return out


@pytest.mark.parametrize("scene,cname", CASES)
def test_sp_matches_jax(scene, cname, jax_runs):
    cfg = CONFIGS[cname]
    raw = _scan(scene)
    pts = pad_scan(raw, DIMS.max_points)
    got = _sp(cfg, pts)
    want = jax_runs[scene, cname]
    for f in ("ok", "roi", "num_rings", "ring_id", "counts", "overflow",
              "star_overflow", "probably_road"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    np.testing.assert_array_max_ulp(got.max_distance, want.max_distance,
                                    maxulp=1)
    assert int(got.overflow) == 0 and bool(got.ok)
    assert got.labels.dtype == np.int8 and got.markers.shape == (361, 6)
    orc = run_oracle(raw, cfg)
    env_runs = _envelope(raw, cfg)
    _assert_labels_vs_jax(got.labels, want.labels, raw, orc.roi_mask, orc,
                          env_runs, f"{scene} {cname} SP labels")
    _assert_markers_vs_jax(got.markers, want.markers, orc, env_runs,
                           f"{scene} {cname} SP markers")
    agree, n_sys = device_parity_gate(raw, got.labels, got.markers, cfg,
                                      scene)
    assert agree >= 0.999 and n_sys == 0, (agree, n_sys)


@pytest.mark.parametrize("scene,cname", CASES)
def test_sp_matches_process_scan(scene, cname):
    """On an azimuth-sorted scan the SP order is the input order, so the
    port's SP result equals its process_scan on every field, and no kernel
    launches on the CPU."""
    cfg = filter_config(CONFIGS[cname])
    pts = pad_scan(_scan(scene), DIMS.max_points)
    reset_launch_counts()
    got = _sp(cfg, pts)
    assert not any(launch_counts().values())
    want = to_numpy(process_scan(pts, cfg, DIMS, device="cpu"))
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert (got.labels == 1).sum() > 500 and got.markers[:, 0].sum() > 100


def test_rows_equal_planar():
    cfg = JaxConfig()
    raw = _scan("two_curbs")
    rows = _sp(cfg, pad_scan(raw, DIMS.max_points))
    planar = _sp(cfg, pad_scan_planar(raw, DIMS.max_points), layout="planar")
    for f in rows._fields:
        np.testing.assert_array_equal(getattr(planar, f), getattr(rows, f),
                                      err_msg=f)


def test_overflow_when_all_points_in_one_wedge():
    """All points crammed into one wedge overflow its capacity and are
    counted (tests/test_azimuth_parallel.py:91-111); a balanced scan
    reports zero."""
    rng = np.random.default_rng(3)
    n = DIMS.max_points
    m = n // 4
    pts = np.zeros((n, 4), np.float32)
    pts[:m, 0] = rng.uniform(5.0, 9.0, m)
    pts[:m, 1] = -pts[:m, 0] * np.float32(np.tan(np.radians(12.0)))
    pts[:m, 2] = -1.2
    out = _sp(JaxConfig(), pts)
    assert int(out.overflow) == m - n // 8
    assert not out.labels[n // 8:].any()  # dropped points stay label 0
    flat = azimuth_sorted(make_scan(SCENES["flat"](), n_rings=16,
                                    n_azimuth=384, seed=5))
    out = _sp(JaxConfig(), pad_scan(flat, n))
    assert int(out.overflow) == 0 and bool(out.ok)


def test_wedge_count_must_divide_360():
    with pytest.raises(ValueError):
        make_azimuth_pipeline(7, filter_config(JaxConfig()), DIMS,
                              device="cpu")


def test_sector_360_walks_with_beam_zero():
    """A point whose f32 sector product rounds to 360 belongs to beam 0
    and travels in beam 0's wedge (tests/test_azimuth_parallel.py:118-),
    so the SP result equals process_scan's on the sorted scan."""
    fi = np.float32(math.atan2(np.float32(-1e-7), np.float32(10.0))) \
        + np.float32(2 * math.pi)
    assert int(np.float32(fi) * np.float32(360 / (2 * math.pi))) == 360
    m = 40
    xs = (2.0 + 0.05 * np.arange(m)).astype(np.float32)
    beam0 = np.stack([xs, np.full(m, 1e-4, np.float32),
                      np.where(np.arange(m) >= 30, -1.0,
                               -1.8).astype(np.float32),
                      np.zeros(m, np.float32)], axis=1)
    stray = np.array([[10.0, -1e-7, -1.8, 0.0]], np.float32)
    fill = azimuth_sorted(make_scan(SCENES["flat"](), n_rings=16,
                                    n_azimuth=256, seed=9))
    scan = azimuth_sorted(np.concatenate([beam0, stray, fill[:4000]]))
    pts = pad_scan(scan, DIMS.max_points)
    t = torch.from_numpy(pts)
    _, fk, _, _ = ingest.ingest_prep(t[None, :, 0], t[None, :, 1],
                                     t[None, :, 2], filter_config(JaxConfig()))
    is_beam0 = np.isin(pts[:, 0], xs) | (pts[:, 1] == np.float32(-1e-7))
    assert (fk[0].numpy()[is_beam0] == 0).all()
    cfg = JaxConfig()
    got = _sp(cfg, pts)
    want = to_numpy(process_scan(pts, filter_config(cfg), DIMS,
                                 device="cpu"))
    np.testing.assert_array_equal(got.labels, want.labels)
    assert (got.labels[is_beam0] == 2).any()


def test_wedge_of_matches_jax():
    """The wedge of each point (from ingest K1's beam) equals the JAX
    _wedge_of on seeded points all around the sensor."""
    rng = np.random.default_rng(17)
    n = 100000
    x = rng.uniform(-30, 30, n).astype(np.float32)
    y = rng.uniform(-30, 30, n).astype(np.float32)
    z = rng.uniform(-2, 0.5, n).astype(np.float32)
    cfg = filter_config(JaxConfig())
    t = [torch.from_numpy(a)[None] for a in (x, y, z)]
    valid, fk, _, _ = ingest.ingest_prep(*t, cfg)
    roi = valid[0].numpy()
    assert roi.sum() > 2000
    for d in (8, 4, 360):
        got = wedge_of(fk[0], valid[0], d).numpy()
        want = np.asarray(jax_wedge_of(jax.numpy.asarray(x),
                                       jax.numpy.asarray(y), d))
        np.testing.assert_array_equal(got[roi], want[roi])
        assert (got[~roi] == d).all()  # outside the ROI: no wedge


def test_run_defaults_to_the_card():
    """Without a CUDA device, run with no device raises; device="cpu"
    runs the plain twins."""
    pts = pad_scan(_scan("two_curbs"), DIMS.max_points)
    cfg = filter_config(JaxConfig(star_shaped_method=False))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_azimuth_pipeline(8, cfg, DIMS)(pts)
    assert bool(make_azimuth_pipeline(8, cfg, DIMS, device="cpu")(pts).ok)


@pytest.mark.parametrize("slack,raises", [(8.0, True), (7.96875, False)])
def test_marker_positions_must_stay_f32_exact(slack, raises):
    """K14 carries the global scan position g < rings x P_glob in f32, with
    P_glob <= min(N, wedges x slots per wedge) + 1.  At 128 rings, 262144
    points and 16384 ring slots, wedge_slack 8 gives 16384 slots per wedge:
    128 x (131072 + 1) passes 2^24, and make_azimuth_pipeline refuses it;
    7.96875 gives 16320: 128 x (130560 + 1) stays below, and it builds."""
    dims = PipelineDims(max_points=262144, rings=128, ring_capacity=16384,
                        beam_capacity=1024)
    cfg = filter_config(JaxConfig())
    if raises:
        with pytest.raises(ValueError, match="f32-exact"):
            make_azimuth_pipeline(8, cfg, dims, wedge_slack=slack,
                                  device="cpu")
    else:
        assert callable(make_azimuth_pipeline(8, cfg, dims,
                                              wedge_slack=slack,
                                              device="cpu"))
