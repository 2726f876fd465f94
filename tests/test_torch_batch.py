"""The port's batch path (pipeline.process_batch) on the CPU: every lane
equals process_scan of its scan on every field, and the batch agrees with
the JAX package's process_batch_jit, exactly or within the classes of
tests/test_torch_pipeline.py (boundary azimuths and the oracle's own ulp
envelope).  The batch holds three scenes and a scan of 10 points, which
the >= 30-point guard must gate off in its lane alone.
"""

import numpy as np
import pytest
import torch

from urban_road_filter_tpu.config import FilterConfig, PipelineDims
from urban_road_filter_tpu.io.synthetic import SCENES, make_scan
from urban_road_filter_tpu.oracle import run_oracle
from urban_road_filter_tpu.pipeline import planarize_batch as jplanarize
from urban_road_filter_tpu.pipeline import process_batch_jit
from urban_road_filter_torch import (
    ScanResult, launch_counts, pad_scan, planarize_batch, process_batch,
    process_scan, reset_launch_counts)
from urban_road_filter_torch.convert import to_numpy
from test_torch_pipeline import (
    _assert_labels_vs_jax, _assert_markers_vs_jax, _envelope)

torch.set_num_threads(1)  # tier-1 runs several pytest workers

DIMS = PipelineDims(max_points=16384, rings=64, ring_capacity=1024)
SCENE_MIX = ("two_curbs", "blind_spot", "curb_gap")
CONFIGS = {"star": FilterConfig(),
           "star_off": FilterConfig(star_shaped_method=False)}


@pytest.fixture(scope="module")
def scans():
    out = [make_scan(SCENES[s](), n_rings=24, n_azimuth=384, seed=7 + i)
           for i, s in enumerate(SCENE_MIX)]
    out.append(np.tile(np.float32([[1, 0, -2, 0]]), (10, 1)))
    return out


@pytest.fixture(scope="module")
def rows(scans):
    return np.stack([pad_scan(s, DIMS.max_points) for s in scans])


@pytest.fixture(scope="module")
def jax_batches(rows):
    """process_batch_jit on the planar batch, per configuration."""
    return {name: process_batch_jit(jplanarize(rows), cfg, DIMS)
            for name, cfg in CONFIGS.items()}


def _batch(rows, layout, cfg):
    pts = rows if layout == "rows" else planarize_batch(rows)
    return to_numpy(process_batch(torch.from_numpy(pts), cfg, DIMS,
                                  layout=layout, device="cpu"))


@pytest.mark.parametrize("layout", ["rows", "planar"])
@pytest.mark.parametrize("cname", sorted(CONFIGS))
def test_lanes_equal_process_scan(rows, layout, cname):
    cfg = CONFIGS[cname]
    got = _batch(rows, layout, cfg)
    assert isinstance(got, ScanResult)
    b = len(rows)
    assert got.markers.shape == (b, 361, 6) and got.labels.shape == (
        b, DIMS.max_points)
    for f in ("ok", "num_rings", "overflow", "star_overflow"):
        assert getattr(got, f).shape == (b,), f
    for k, pts in enumerate(rows):
        one = to_numpy(process_scan(torch.from_numpy(pts), cfg, DIMS,
                                     device="cpu"))
        for f in ScanResult._fields:
            np.testing.assert_array_equal(getattr(got, f)[k], getattr(one, f),
                                          err_msg=f"lane {k} {f}")
    assert got.ok.tolist() == [True, True, True, False]
    assert not got.labels[3].any() and not got.markers[3].any()


@pytest.mark.parametrize("cname", sorted(CONFIGS))
def test_matches_jax_batch(rows, scans, jax_batches, cname):
    cfg = CONFIGS[cname]
    got = _batch(rows, "planar", cfg)
    jx = ScanResult(*(np.asarray(f) for f in jax_batches[cname]))
    for f in ("ok", "num_rings", "counts", "overflow", "roi"):
        np.testing.assert_array_equal(getattr(got, f), getattr(jx, f),
                                      err_msg=f)
    assert np.mean(got.ring_id == jx.ring_id) >= 0.9999
    for k, pts in enumerate(scans[:3]):
        orc = run_oracle(pts, cfg)
        env = _envelope(pts, cfg)
        what = f"{cname} lane {k}"
        _assert_labels_vs_jax(got.labels[k], jx.labels[k], pts, orc.roi_mask,
                              orc, env, f"{what} labels")
        _assert_markers_vs_jax(got.markers[k], jx.markers[k], orc, env,
                               f"{what} markers")


def test_planarize_batch_matches_jax(rows):
    got = planarize_batch(rows)
    want = jplanarize(rows)
    assert got.shape == (3,) + rows.shape[:2] and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)


def test_layout_is_named_not_guessed(rows):
    pts = torch.from_numpy(rows)
    with pytest.raises(ValueError):
        process_batch(pts, FilterConfig(), DIMS, layout="planar",
                      device="cpu")
    with pytest.raises(ValueError):
        process_batch(pts[0], FilterConfig(), DIMS,  # one scan, not a batch
                      device="cpu")
    with pytest.raises(ValueError):
        process_batch(pts, FilterConfig(), DIMS, layout="auto",
                      device="cpu")


def test_cpu_batch_launches_no_kernel(rows):
    reset_launch_counts()
    process_batch(torch.from_numpy(rows[:2]), CONFIGS["star"], DIMS,
                  device="cpu")
    assert not any(launch_counts().values())
