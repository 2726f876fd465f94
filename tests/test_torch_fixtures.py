"""The recorded-style PCD fixtures through the port, on the CPU (the
kernels' plain twins), against the JAX pipeline and the numpy oracle.

tests/fixtures holds three binary_compressed PCDs of 16384 points with
more than 100 NaN rows each (missing returns, as PCL's organised clouds
arrive).  Each is read by the port's own reader (io.pcd with its native
path) and sent through ``process_scan`` with its NaN rows as they are:
the ring structure must equal the JAX ``process_scan_jit``'s exactly, and
labels and markers exactly or classified as in tests/test_torch_pipeline.py
(a flip within 1e-4 degrees of a bin edge, or inside the oracle's own ulp
envelope); against the oracle the gate must pass at >= 0.999 with 0
systematic flips.  No NaN row may be labelled, and the scan with its NaN
rows replaced by zero rows must give bit-equal labels, markers and ROI
(both are dropped by the ROI filter).  Mirrors tests/test_fixtures.py.
"""

import glob
import os

import numpy as np
import pytest
import torch

from test_torch_pipeline import DIMS, _check_slice
from urban_road_filter_tpu.config import FilterConfig
from urban_road_filter_tpu.io.pcd import read_pcd as jax_read_pcd
from urban_road_filter_torch import pad_scan, process_scan
from urban_road_filter_torch.convert import to_numpy
from urban_road_filter_torch.io.pcd import read_pcd
from urban_road_filter_torch.utils.parity import device_parity_gate

torch.set_num_threads(1)  # tier-1 runs several pytest workers

FIXTURES = sorted(glob.glob(os.path.join(os.path.dirname(__file__),
                                         "fixtures", "*.pcd")))


def test_three_fixtures():
    assert len(FIXTURES) == 3
    assert DIMS.max_points == 16384  # the fixtures' size, nothing cut


@pytest.mark.parametrize("path", FIXTURES,
                         ids=[os.path.basename(p) for p in FIXTURES])
def test_fixture_through_the_port(path):
    cfg = FilterConfig()
    name = os.path.basename(path)
    pts = read_pcd(path)
    np.testing.assert_array_equal(pts.view(np.int32),
                                  jax_read_pcd(path, use_native=False)
                                  .view(np.int32))
    nan = np.isnan(pts[:, 0])
    assert nan.sum() > 100 and len(pts) == DIMS.max_points

    raw, port = _check_slice(pts, cfg, name)
    assert bool(port.ok) and int(port.overflow) == 0
    assert not port.labels[:len(pts)][nan].any(), "a NaN row was labelled"
    assert not port.roi[:len(pts)][nan].any()
    got = port.labels[:len(pts)]
    assert (got == 1).sum() > 100 and (got == 2).sum() > 5
    agree, n_sys = device_parity_gate(pts, port.labels, port.markers, cfg,
                                      name)
    assert agree >= 0.999 and n_sys == 0, (name, agree, n_sys)

    zeros = to_numpy(process_scan(
        torch.from_numpy(pad_scan(np.nan_to_num(pts, nan=0.0),
                                  DIMS.max_points)), cfg, DIMS,
        device="cpu"))
    for f in ("labels", "roi", "probably_road", "ring_id", "num_rings",
              "counts"):
        np.testing.assert_array_equal(getattr(zeros, f), getattr(port, f),
                                      err_msg=f)
    np.testing.assert_array_equal(zeros.markers.view(np.int32),
                                  port.markers.view(np.int32))
