"""Checked mode of the port (urban_road_filter_torch.utils.checked) on the
CPU, case by case beside tests/test_checked.py (the JAX module's checkify
tests):

* the three configurations of ``test_pipeline_index_clean``: the checked
  run's error word is clean, every field bit-equal to the port's
  process_scan, and its labels and markers exact or classified against the
  JAX process_scan_checked (torch's asin and XLA's differ by an ulp on some
  azimuths, and XLA's jitted CPU code fuses multiply-adds; the
  classification of tests/test_torch_pipeline.py);
* the tiny and degenerate scans;
* negative controls (``test_harness_detects_oob``): an address that the
  default path masks silently, corrupted through monkeypatch on a stage (a
  ring id past rings, a hit pid past N, a bin past 360, a negative slot),
  makes process_scan_checked raise naming its contract, ``throw=False``
  returns an error whose ``.get()`` names it, and process_scan on the same
  input returns without error; ``errors`` selects the contracts checked;
* a hot swap of a continuous parameter gives process_scan's outputs under
  the new configuration (``test_checked_hot_swap_is_cache_hit``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pipeline import (
    _assert_labels_vs_jax, _assert_markers_vs_jax, _envelope)
from urban_road_filter_tpu.config import FilterConfig as JaxConfig
from urban_road_filter_tpu.config import PipelineDims as JaxDims
from urban_road_filter_tpu.oracle import run_oracle
from urban_road_filter_tpu.utils.checked import (
    process_scan_checked as jax_checked)
from urban_road_filter_torch import (
    FilterConfig, PipelineDims, pad_scan, process_scan)
from urban_road_filter_torch.io import SCENES, make_scan
from urban_road_filter_torch.utils import checked as ck
from urban_road_filter_torch.utils.checked import (
    INDEX_ERRORS, CheckError, IndexContractError, process_scan_checked)

torch.set_num_threads(1)  # tier-1 runs several pytest workers

DIMS = PipelineDims(max_points=8192, rings=64, ring_capacity=1024,
                    beam_capacity=256)
JDIMS = JaxDims(max_points=8192, rings=64, ring_capacity=1024,
                beam_capacity=256)
CONFIGS = {
    "default": {},
    "starbeam": dict(starbeam_filter=True),
    "blind-no-star": dict(star_shaped_method=False, blind_spots=True,
                          x_direction=0),
}


def _scan(seed=7):
    return make_scan(SCENES["two_curbs"](), n_rings=16, n_azimuth=384,
                     seed=seed)


def _same(got, want):
    for f, a, b in zip(want._fields, got, want):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert a.dtype == b.dtype and torch.equal(a, b), f


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_pipeline_index_clean(name):
    scan = _scan()
    raw = pad_scan(scan, DIMS.max_points)
    pts = torch.from_numpy(raw)
    cfg = FilterConfig(**CONFIGS[name])
    err, out = process_scan_checked(pts, cfg, DIMS, throw=False,
                                    device="cpu")
    assert err.get() is None and err.broken() == []
    _same(out, process_scan(pts, cfg, DIMS, device="cpu"))

    jcfg = JaxConfig(**CONFIGS[name])
    jx = jax_checked(jnp.asarray(raw), jcfg, JDIMS)  # raises on any OOB
    orc = run_oracle(scan, jcfg)
    env = _envelope(scan, jcfg)
    _assert_labels_vs_jax(out.labels.numpy(), np.asarray(jx.labels), scan,
                          orc.roi_mask, orc, env, f"{name} labels")
    _assert_markers_vs_jax(out.markers.numpy(), np.asarray(jx.markers), orc,
                           env, f"{name} markers")


def test_checked_tiny_and_degenerate_scans():
    """The guard paths (ok=False, empty rings) break no contract either."""
    cfg = FilterConfig()
    for raw in [np.zeros((DIMS.max_points, 4), np.float32),
                pad_scan(np.full((40, 4), np.nan, np.float32),
                         DIMS.max_points),
                pad_scan(_scan()[:20], DIMS.max_points)]:
        pts = torch.from_numpy(raw)
        out = process_scan_checked(pts, cfg, DIMS, device="cpu")
        assert not bool(out.ok)
        _same(out, process_scan(pts, cfg, DIMS, device="cpu"))


def _bad_ring_id(monkeypatch):
    """K3's ring ids with one ROI point's id past the table (rings + 3)."""
    from urban_road_filter_torch.ops import ingest

    orig = ingest.assign_rings

    def bad(alpha, valid, angles_sorted, interval):
        ring = orig(alpha, valid, angles_sorted, interval).clone()
        ring[0, int(torch.nonzero(valid[0])[0])] = angles_sorted.shape[-1] + 3
        return ring

    monkeypatch.setattr(ingest, "assign_rings", bad)


def _bad_star_pid(monkeypatch):
    """K4's hits with beam 0's pid past the scan (N + 5)."""
    from urban_road_filter_torch import pipeline

    orig = pipeline.star_hits

    def bad(x, y, z, valid, cfg, keys=None):
        hp = orig(x, y, z, valid, cfg, keys).clone()
        hp[0] = x.shape[0] + 5
        return hp

    monkeypatch.setattr(pipeline, "star_hits", bad)


def _bad_tensorize(monkeypatch, what):
    """tensorize's layout with ring 0 slot 0's azimuth at 400 degrees
    ("bin"), or its slots with one placed point's slot at -1 ("slot")."""
    from urban_road_filter_torch.ops import geometry

    orig = geometry.tensorize

    def bad(x, y, z, ring_id, cap, rings):
        layout, pos = orig(x, y, z, ring_id, cap, rings=rings)
        if what == "bin":
            alpha = layout.alpha.clone()
            alpha[0, 0] = 400.0
            return layout._replace(alpha=alpha), pos
        pos = pos.clone()
        pos[int(torch.nonzero(ring_id < rings)[0])] = -1
        return layout, pos

    monkeypatch.setattr(geometry, "tensorize", bad)


CORRUPTIONS = {
    "ring_id": (_bad_ring_id, ["ring_id"]),
    "star_pid": (_bad_star_pid, ["star_pid"]),
    "marker_bin": (lambda mp: _bad_tensorize(mp, "bin"), ["marker_bin"]),
    "slot": (lambda mp: _bad_tensorize(mp, "slot"), ["pos", "gather_addr"]),
}


@pytest.mark.parametrize("what", sorted(CORRUPTIONS))
def test_checked_detects_oob(what, monkeypatch):
    corrupt, names = CORRUPTIONS[what]
    corrupt(monkeypatch)
    pts = torch.from_numpy(pad_scan(_scan(), DIMS.max_points))
    cfg = FilterConfig()
    process_scan(pts, cfg, DIMS, device="cpu")  # masked silently
    with pytest.raises(IndexContractError, match=names[0]):
        process_scan_checked(pts, cfg, DIMS, device="cpu")
    err, out = process_scan_checked(pts, cfg, DIMS, throw=False,
                                    device="cpu")
    assert isinstance(err, CheckError) and err.broken() == names
    msg = err.get()
    assert all(n in msg for n in names) and ck.CONTRACTS[names[0]][1] in msg
    assert out.labels.shape == (DIMS.max_points,)


def test_errors_select_the_contracts(monkeypatch):
    _bad_ring_id(monkeypatch)
    pts = torch.from_numpy(pad_scan(_scan(), DIMS.max_points))
    cfg = FilterConfig()
    process_scan_checked(pts, cfg, DIMS, errors=INDEX_ERRORS - {"ring_id"},
                         device="cpu")
    with pytest.raises(IndexContractError, match="ring_id"):
        process_scan_checked(pts, cfg, DIMS, errors={"ring_id"},
                             device="cpu")
    with pytest.raises(ValueError, match="unknown index contracts"):
        process_scan_checked(pts, cfg, DIMS, errors={"nan"}, device="cpu")
    assert INDEX_ERRORS == frozenset(ck.CONTRACTS)
    bits = [bit for bit, _, _ in ck.CONTRACTS.values()]
    assert sorted(bits) == list(range(len(bits)))


def test_checked_hot_swap():
    """A continuous parameter swapped between calls: the checked run
    equals process_scan under the new configuration."""
    pts = torch.from_numpy(pad_scan(_scan(seed=9), DIMS.max_points))
    cfg = FilterConfig()
    first = process_scan_checked(pts, cfg, DIMS, device="cpu")
    swapped = cfg.replace(max_x=12.0)
    out = process_scan_checked(pts, swapped, DIMS, device="cpu")
    _same(out, process_scan(pts, swapped, DIMS, device="cpu"))
    assert 0 < int(out.roi.sum()) < int(first.roi.sum())
