"""The port's own copies of the JAX package's JAX-free modules (config,
constants, io, oracle, utils.parity) behave as the originals; the entry
points run on the card unless the caller asks for the CPU; and the port's
copy of the oracle gate calls a ring mis-assigned beyond its ulp envelope
systematic.
"""

import numpy as np
import pytest
import torch

from urban_road_filter_tpu import constants as jconstants
from urban_road_filter_tpu.config import FilterConfig as JaxConfig
from urban_road_filter_tpu.config import PipelineDims as JaxDims
from urban_road_filter_tpu.io import multi_lidar as jmulti
from urban_road_filter_tpu.io import synthetic as jsynthetic
from urban_road_filter_tpu.oracle import run_oracle as jax_oracle
from urban_road_filter_torch import (
    FilterConfig, PipelineDims, constants, pad_scan, packed_scan,
    planarize_batch, process_batch, process_scan)
from urban_road_filter_torch.convert import filter_config
from urban_road_filter_torch.io import (
    SCENES, Extrinsics, make_drive, make_scan, make_sensor_scan, merge_scans)
from urban_road_filter_torch.oracle import run_oracle
from urban_road_filter_torch.oracle.reference import vertical_angles
from urban_road_filter_torch.utils.parity import device_parity_gate

torch.set_num_threads(1)  # tier-1 runs several pytest workers

DIMS = PipelineDims(max_points=16384, rings=64, ring_capacity=1024)


def test_filter_config_copy():
    assert FilterConfig().to_dict() == JaxConfig().to_dict()
    jcfg = JaxConfig(beam_zone=45.5, curb_points=3, star_shaped_method=False)
    cfg = filter_config(jcfg)
    assert isinstance(cfg, FilterConfig)
    assert cfg.to_dict() == jcfg.to_dict()
    assert (cfg.cos_x, cfg.cos_z) == (jcfg.cos_x, jcfg.cos_z)
    for kind in ("vlp16", "os1-64", "os1-128", "tiny"):
        assert (PipelineDims.for_sensor(kind).__dict__
                == JaxDims.for_sensor(kind).__dict__)


def test_constants_copy():
    for name in ("CHANNELS", "LABEL_CURB", "LABEL_ROAD", "MIN_POINTS",
                 "STAR_KFI", "STAR_REP", "PROBABLY_ROAD_RING"):
        assert getattr(constants, name) == getattr(jconstants, name), name
    for got, want in zip(constants.beam_tables(), jconstants.beam_tables()):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_make_scan_bytes(scene):
    got = make_scan(SCENES[scene](), n_rings=16, n_azimuth=256, seed=3)
    want = jsynthetic.make_scan(jsynthetic.SCENES[scene](), n_rings=16,
                                n_azimuth=256, seed=3)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_drive_sensor_and_merge_bytes():
    got = next(make_drive(1, sensor="os1_64", seed=41, firings=256))
    want = next(jsynthetic.make_drive(1, sensor="os1_64", seed=41,
                                      firings=256))
    assert got.tobytes() == want.tobytes()
    spec = SCENES["two_curbs"]()
    scans = [make_sensor_scan(spec, "os1_64", seed=s, firings=128)
             for s in (70, 71)]
    jscans = [jsynthetic.make_sensor_scan(jsynthetic.SCENES["two_curbs"](),
                                          "os1_64", seed=s, firings=128)
              for s in (70, 71)]
    exts = [Extrinsics(x=0.4, y=0.3, z=0.0, yaw_deg=1.5),
            Extrinsics(x=-0.4, y=-0.3, z=-0.05, yaw_deg=-2.0)]
    jexts = [jmulti.Extrinsics(**e.__dict__) for e in exts]
    assert (merge_scans(scans, exts).tobytes()
            == jmulti.merge_scans(jscans, jexts).tobytes())


@pytest.mark.parametrize("star", [True, False])
def test_oracle_copy(star):
    scan = make_scan(SCENES["blind_spot"](), n_rings=24, n_azimuth=384,
                     seed=2)
    cfg = FilterConfig(star_shaped_method=star)
    got = run_oracle(scan, cfg)
    want = jax_oracle(scan, JaxConfig(star_shaped_method=star))
    assert got.num_rings == want.num_rings
    np.testing.assert_array_equal(got.roi_mask, want.roi_mask)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.marker_bins, want.marker_bins)
    np.testing.assert_array_equal(got.marker_points, want.marker_points)


def _pts():
    scan = make_scan(SCENES["two_curbs"](), n_rings=16, n_azimuth=256, seed=1)
    return pad_scan(scan, DIMS.max_points)


def test_entry_points_default_to_the_card():
    """device=None means "cuda": without a CUDA device every entry point
    raises and names the way to the CPU; device="cpu" runs the twins,
    from a host array as from a tensor."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = FilterConfig(star_shaped_method=False)
    pts = _pts()
    batch = planarize_batch(pts[None])
    for call in (lambda **kw: process_scan(pts, cfg, DIMS, **kw),
                 lambda **kw: packed_scan(torch.from_numpy(pts), cfg, DIMS,
                                          **kw),
                 lambda **kw: process_batch(batch, cfg, DIMS,
                                            layout="planar", **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call(device="cuda")
        call(device="cpu")
    a = process_scan(pts, cfg, DIMS, device="cpu")
    b = process_scan(torch.from_numpy(pts), cfg, DIMS, device="cpu")
    assert a.labels.device.type == "cpu" and torch.equal(a.labels, b.labels)
    with pytest.raises(ValueError):
        process_scan(pts, cfg, DIMS, device="meta")


def _dense(res):
    table = np.zeros((361, 6), np.float32)
    table[:, 5] = np.arange(361)
    for i, b in enumerate(res.marker_bins):
        table[b, 0] = 1.0
        table[b, 1:5] = res.marker_points[i]
    return table


def test_gate_calls_a_misassigned_ring_systematic():
    """The gate nudges ``interval`` by 1e-4 relative (about 2 ulp of the
    vertical angle).  Half of one ring is moved to 1 + 6e-4 intervals from
    its representative, so the reference makes it a ring of its own; a
    device that matched rings 2e-3 too loosely keeps it in the old ring.
    Those labels must count as systematic flips, while the reference's own
    labels pass with none."""
    cfg = FilterConfig()
    scan = make_scan(SCENES["two_curbs"](), n_rings=24, n_azimuth=384, seed=7)
    orc = run_oracle(scan, cfg)
    k = 5
    rep = orc.ring_angles[k]
    moved = np.flatnonzero(orc.roi_mask)[orc.ring_point_ids[k][1::2]]
    interval = np.float32(cfg.interval)
    r = np.hypot(scan[moved, 0].astype(np.float64),
                 scan[moved, 1].astype(np.float64))
    target = np.radians(np.float64(rep) + np.float64(interval) * (1 + 6e-4))
    scan[moved, 2] = (-r / np.tan(target)).astype(np.float32)
    _, av = vertical_angles(scan[moved, 0], scan[moved, 1], scan[moved, 2])
    beyond = (av - rep) / interval - 1
    assert (beyond > 2e-4).all() and (beyond < 2e-3).all(), beyond
    exact = run_oracle(scan, cfg)
    assert exact.num_rings == orc.num_rings + 1
    loose = run_oracle(scan, cfg.replace(interval=cfg.interval * (1 + 2e-3)))
    assert loose.num_rings == orc.num_rings
    assert (loose.labels != exact.labels).sum() > 5
    table = _dense(exact)
    for res, systematic in ((exact, False), (loose, True)):
        labels = np.zeros(len(scan), np.int8)
        labels[exact.roi_mask] = res.labels
        agree, n_sys = device_parity_gate(scan, labels, table, cfg, "ring")
        assert (n_sys > 0) == systematic, (agree, n_sys)
