"""The port's data parallelism (urban_road_filter_torch.parallel.
data_parallel.make_sharded_pipeline) on the CPU, beside tests/
test_parallel.py: a batch split over 1, 2 and 3 "cpu" entries equals
process_batch lane for lane and field for field; planar input equals rows
(the layout is named, never guessed: rows of 3 columns too); ``cfg_now``
swaps the configuration for one call; uneven splits and empty chunks are
correct.  The JAX package's make_sharded_pipeline on a one-device CPU mesh,
with and without ``cfg_now``, agrees with it on the same batch exactly or
within the classes of tests/test_torch_pipeline.py.  On the card, chip_smoke.py phase 7 runs it over [cuda:0] and
[cuda:0, cuda:0] on the 128-scan batch."""

import numpy as np
import pytest
import torch

from test_torch_pipeline import (
    _assert_labels_vs_jax, _assert_markers_vs_jax, _envelope)
from urban_road_filter_tpu.config import FilterConfig as JFilterConfig
from urban_road_filter_tpu.oracle import run_oracle
from urban_road_filter_tpu.parallel.data_parallel import (
    make_sharded_pipeline as jax_sharded_pipeline)
from urban_road_filter_tpu.parallel.mesh import make_mesh
from urban_road_filter_torch import (
    FilterConfig, PipelineDims, pad_scan, planarize_batch, process_batch)
from urban_road_filter_torch.io import SCENES, make_scan
from urban_road_filter_torch.parallel.data_parallel import (
    make_sharded_pipeline)

torch.set_num_threads(1)  # tier-1 runs several pytest workers

DIMS = PipelineDims(max_points=4096, rings=64, ring_capacity=512,
                    beam_capacity=128)


@pytest.fixture(scope="module")
def scans():
    return [make_scan(SCENES["two_curbs" if i % 2 else "blind_spot"](),
                      n_rings=16, n_azimuth=192, seed=i) for i in range(5)]


@pytest.fixture(scope="module")
def batch(scans):
    return np.stack([pad_scan(s, DIMS.max_points) for s in scans])


@pytest.fixture(scope="module")
def reference(batch):
    return process_batch(torch.from_numpy(batch), FilterConfig(), DIMS,
                         device="cpu")


def _same(got, want):
    assert type(got) is type(want)
    for f, a, b in zip(want._fields, got, want):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert a.shape == b.shape and torch.equal(a, b), f


@pytest.mark.parametrize("n_devices", [1, 2, 3])
def test_matches_process_batch(batch, reference, n_devices):
    run = make_sharded_pipeline(["cpu"] * n_devices, FilterConfig(), DIMS)
    out = run(torch.from_numpy(batch))
    _same(out, reference)
    assert out.labels.device.type == "cpu" and out.ok.shape == (5,)
    assert bool(out.ok.all())


def test_planar_matches_rows(batch, reference):
    run = make_sharded_pipeline(["cpu", "cpu"], FilterConfig(), DIMS)
    _same(run(planarize_batch(batch), layout="planar"), reference)
    _same(run(np.ascontiguousarray(batch[..., :3])), reference)


def test_cfg_now_hot_swaps(batch):
    run = make_sharded_pipeline(["cpu"] * 3, FilterConfig(), DIMS)
    swapped = FilterConfig(beam_zone=50.0, star_shaped_method=False)
    out = run(torch.from_numpy(batch), cfg_now=swapped)
    _same(out, process_batch(torch.from_numpy(batch), swapped, DIMS,
                             device="cpu"))
    again = run(torch.from_numpy(batch))
    assert not torch.equal(out.labels, again.labels)


@pytest.mark.parametrize("swap", [None, {"beam_zone": 50.0}],
                         ids=["cfg", "cfg_now"])
def test_matches_jax_sharded_pipeline(batch, scans, swap):
    """The same batch through the JAX make_sharded_pipeline on a
    one-device mesh and the port's over two "cpu" entries, the
    configuration given at construction or swapped per call."""
    import jax

    cfg = FilterConfig(**(swap or {}))
    jrun = jax_sharded_pipeline(make_mesh(n_data=1,
                                          devices=jax.devices()[:1]),
                                JFilterConfig(), DIMS)
    jx = jrun(batch, None if swap is None else JFilterConfig(**swap))
    run = make_sharded_pipeline(["cpu", "cpu"], FilterConfig(), DIMS)
    got = run(torch.from_numpy(batch),
              cfg_now=None if swap is None else cfg)
    got = type(got)(*(f.numpy() for f in got))
    for f in ("ok", "num_rings", "counts", "overflow", "roi"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(jx, f)), err_msg=f)
    assert np.mean(got.ring_id == np.asarray(jx.ring_id)) >= 0.9999
    jcfg = JFilterConfig(**(swap or {}))
    for k, pts in enumerate(scans):
        orc = run_oracle(pts, jcfg)
        env = _envelope(pts, jcfg)
        what = f"{'cfg_now' if swap else 'cfg'} lane {k}"
        _assert_labels_vs_jax(got.labels[k], np.asarray(jx.labels[k]), pts,
                              orc.roi_mask, orc, env, f"{what} labels")
        _assert_markers_vs_jax(got.markers[k], np.asarray(jx.markers[k]),
                               orc, env, f"{what} markers")


def test_uneven_split_and_empty_chunks(batch, reference):
    """5 lanes over 3 devices (2, 2, 1) and 2 lanes over 3 (one device
    idle): each lane equals its process_batch lane."""
    run = make_sharded_pipeline(["cpu"] * 3, FilterConfig(), DIMS)
    _same(run(torch.from_numpy(batch)), reference)
    out = run(torch.from_numpy(batch[3:]))
    _same(out, type(reference)(*(f[3:] for f in reference)))


def test_refuses_bad_input(batch):
    run = make_sharded_pipeline(["cpu", "cpu"], FilterConfig(), DIMS)
    with pytest.raises(ValueError, match="layout"):
        run(torch.from_numpy(batch), layout="auto")
    with pytest.raises(ValueError, match="non-empty"):
        run(torch.from_numpy(batch[:0]))
    with pytest.raises(ValueError, match="non-empty"):
        run(torch.from_numpy(batch[0]))
    with pytest.raises(ValueError, match="at least one device"):
        make_sharded_pipeline([], FilterConfig(), DIMS)
