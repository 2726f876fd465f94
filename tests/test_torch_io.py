"""The port's copies of the JAX package's host modules, held to the
originals on the same inputs, on the CPU.

``urban_road_filter_torch`` carries its own copies of ``io/pcd.py`` (with
the LZF codec and the NPZ sequences), ``runtime/native.py`` with its g++
reader ``runtime/csrc/urf_native.cpp`` (built into the port's own cache),
``io/rosbag.py``, ``postprocess.py``, ``utils/metrics.py`` and ``viz.py``,
because the port imports nothing of the JAX package.  Each is held here
to its original on inputs made from a numpy seed, exactly: the same bytes
written, the same arrays read (float outputs compared by their bits, so
NaN rows must match), the same marker strips, the same summaries.  The
cases mirror tests/test_io_runtime.py (TestPcd, TestNativeStaging),
tests/test_rosbag.py and tests/test_postprocess.py.
"""

import glob
import os

import numpy as np
import pytest

from urban_road_filter_tpu import postprocess as jpost
from urban_road_filter_tpu.io import pcd as jpcd
from urban_road_filter_tpu.io import rosbag as jbag
from urban_road_filter_tpu.io.synthetic import SCENES, make_scan
from urban_road_filter_tpu.runtime import native as jnative
from urban_road_filter_tpu.utils import metrics as jmetrics
from urban_road_filter_torch import postprocess as tpost
from urban_road_filter_torch.io import pcd as tpcd
from urban_road_filter_torch.io import rosbag as tbag
from urban_road_filter_torch.runtime import native as tnative
from urban_road_filter_torch.utils import metrics as tmetrics

FIXTURES = sorted(glob.glob(os.path.join(os.path.dirname(__file__),
                                         "fixtures", "*.pcd")))
F32 = np.float32


def _same(a, b):
    """Bit-equal arrays (NaNs must match)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
    if a.dtype == F32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def lib():
    lib = tnative.get_lib()
    assert lib is not None, "g++ must build the port's native reader here"
    return lib


def test_native_library_is_the_ports_own(lib):
    """Built into urban_road_filter_torch/runtime/_build/, never the JAX
    package's cache."""
    here = os.path.dirname(os.path.abspath(tnative.__file__))
    assert os.path.dirname(lib._name) == os.path.join(here, "_build")
    assert lib.urf_native_abi_version() == 2


class TestPcd:
    @pytest.mark.parametrize("path", FIXTURES,
                             ids=[os.path.basename(p) for p in FIXTURES])
    def test_fixtures_python_and_native(self, path, lib):
        want = jpcd.read_pcd(path, use_native=False)
        assert np.isnan(want[:, 0]).sum() > 100
        _same(tpcd.read_pcd(path, use_native=False), want)
        _same(tnative.read_pcd_native(path), want)
        _same(tpcd.read_pcd(path), want)

    @pytest.mark.parametrize("kind", ["binary", "ascii", "compressed"])
    def test_roundtrips(self, kind, tmp_path, lib):
        rng = np.random.default_rng({"binary": 0, "ascii": 1,
                                     "compressed": 4}[kind])
        pts = rng.normal(size=(3000, 4)).astype(F32)
        kw = dict(binary=kind != "ascii", compressed=kind == "compressed")
        mine, theirs = tmp_path / "t.pcd", tmp_path / "j.pcd"
        tpcd.write_pcd(mine, pts, **kw)
        jpcd.write_pcd(theirs, pts, **kw)
        assert mine.read_bytes() == theirs.read_bytes()
        want = jpcd.read_pcd(theirs, use_native=False)
        _same(tpcd.read_pcd(mine, use_native=False), want)
        _same(tnative.read_pcd_native(str(mine)), want)
        if kind != "ascii":
            _same(want, pts)

    def test_structured_cloud_compresses(self, tmp_path):
        pts = np.random.default_rng(4).normal(size=(50, 4)).astype(F32)
        grid = np.tile(pts, (60, 1))
        p = tmp_path / "g.pcd"
        tpcd.write_pcd(p, grid, compressed=True)
        assert p.stat().st_size < grid.nbytes // 4
        _same(tpcd.read_pcd(p, use_native=False), grid)

    def test_xyz_only_pcd(self, tmp_path, lib):
        p = tmp_path / "b.pcd"
        p.write_bytes(b"VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
                      b"COUNT 1 1 1\nWIDTH 2\nHEIGHT 1\nPOINTS 2\n"
                      b"DATA ascii\n1 2 3\n4 5 6\n")
        want = jpcd.read_pcd(p, use_native=False)
        np.testing.assert_allclose(want, [[1, 2, 3, 0], [4, 5, 6, 0]])
        _same(tpcd.read_pcd(p, use_native=False), want)
        _same(tnative.read_pcd_native(str(p)), want)

    def test_lzf_codec(self):
        rng = np.random.default_rng(0)
        for blob in (b"abcabcabcabcabcabc" * 50, rng.bytes(1000),
                     b"\x00" * 5000, rng.bytes(50) * 40 + rng.bytes(77)):
            comp = tpcd.lzf_compress(blob)
            assert comp == jpcd.lzf_compress(blob)
            assert tpcd.lzf_decompress(comp, len(blob)) == blob
        stream = bytes([0x02]) + b"abc" + bytes([(7 << 5) | 0, 9 - 7, 2])
        assert tpcd.lzf_decompress(stream, 14) == b"abc" + b"abcabcabcab"

    def test_native_lzf_fuzz_vs_python(self, lib):
        rng = np.random.default_rng(7)
        blobs = [rng.bytes(1), b"", b"\x00" * 10000, rng.bytes(4096),
                 rng.bytes(64) * 100,
                 np.arange(20000, dtype=F32).tobytes(),
                 bytes(rng.integers(0, 4, 30000, dtype=np.uint8))]
        for blob in blobs:
            comp = tpcd.lzf_compress(blob)
            assert tnative.lzf_decompress_native(comp, len(blob)) == blob
            assert jpcd.lzf_decompress(comp, len(blob)) == blob
        for bad in (bytes([7 << 5]), bytes([1 << 5]),
                    bytes([0x02]) + b"ab",  # literal run past the end
                    bytes([0x00, 0x61, (1 << 5), 0x63])):  # ref before start
            for decode in (tnative.lzf_decompress_native,
                           tpcd.lzf_decompress, jpcd.lzf_decompress):
                with pytest.raises(ValueError):
                    decode(bad, 64)

    @pytest.mark.parametrize("bad", [b"99999999999999", b"-5", b"0"])
    def test_native_rejects_hostile_header(self, bad, tmp_path, lib):
        p = tmp_path / "bad.pcd"
        p.write_bytes((b"VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
                       b"COUNT 1 1 1\nWIDTH 1\nHEIGHT 1\nPOINTS %s\n"
                       b"DATA binary\n" % bad) + b"\x00" * 12)
        for read in (tnative.read_pcd_native, jnative.read_pcd_native):
            with pytest.raises(ValueError):
                read(str(p))

    def test_native_truncated_binary_rejected(self, tmp_path, lib):
        p = tmp_path / "short.pcd"
        p.write_bytes(b"VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
                      b"COUNT 1 1 1\nWIDTH 100\nHEIGHT 1\nPOINTS 100\n"
                      b"DATA binary\n" + b"\x00" * (12 * 10))
        for read in (tnative.read_pcd_native, jnative.read_pcd_native):
            with pytest.raises(ValueError):
                read(str(p))

    def test_npz_sequence(self, tmp_path):
        rng = np.random.default_rng(3)
        scans = [rng.random((100 + i, 4)).astype(F32) for i in range(3)]
        p = tmp_path / "seq.npz"
        tpcd.write_scan_sequence(p, scans)
        got = list(tpcd.read_scan_sequence(p))
        want = list(jpcd.read_scan_sequence(p))
        assert len(got) == len(want) == 3
        for a, b, c in zip(got, want, scans):
            _same(a, b)
            _same(a, c)


def test_stage_batch_native(lib):
    rng = np.random.default_rng(5)
    scans = [rng.random((50, 4)).astype(F32), rng.random((20, 3)).astype(F32),
             rng.random((70, 4)).astype(F32)]
    got = tnative.stage_batch_native(scans, 64)
    _same(got, jnative.stage_batch_native(scans, 64))
    assert got.shape == (3, 64, 4)
    _same(got[0, :50], scans[0])
    assert not got[1, 20:].any() and not got[1, :, 3].any()
    _same(got[2], scans[2][:64])


class TestRosbag:
    @pytest.fixture(scope="class")
    def scans(self):
        return [make_scan(SCENES["two_curbs"](), n_rings=16, n_azimuth=256,
                          seed=i) for i in range(3)]

    def test_write_bag_bytes_and_read_bag(self, scans, tmp_path):
        mine, theirs = str(tmp_path / "t.bag"), str(tmp_path / "j.bag")
        tbag.write_bag(mine, scans, topic="/pts", rate_hz=10.0)
        jbag.write_bag(theirs, scans, topic="/pts", rate_hz=10.0)
        assert open(mine, "rb").read() == open(theirs, "rb").read()
        got = list(tbag.read_bag(mine))
        want = list(jbag.read_bag(mine))
        assert len(got) == len(want) == 3
        for a, b, s in zip(got, want, scans):
            _same(a, b)
            _same(a, s[:, :4])
        assert tbag.bag_topics(mine) == jbag.bag_topics(mine) == {
            "/pts": "sensor_msgs/PointCloud2"}
        assert list(tbag.read_bag(mine, topic="/other")) == []

    def test_not_a_bag(self, tmp_path):
        path = str(tmp_path / "x.bag")
        with open(path, "wb") as f:
            f.write(b"#ROSBAG V1.2\n junk")
        with pytest.raises(tbag.BagFormatError):
            list(tbag.read_bag(path))


def _marker_rows(seed, n=120):
    """Seeded (n, 4) marker rows [x, y, z, flag] along a curb line, flags
    in runs with single-row blips (what smoothing removes)."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(-40, 40, n))
    rows = np.stack([t, 3.5 + 0.3 * np.sin(t / 7) + rng.normal(0, 0.05, n),
                     rng.normal(-1.6, 0.05, n),
                     np.repeat(rng.integers(0, 2, n // 8 + 1), 8)[:n]],
                    1).astype(F32)
    blips = rng.choice(n, n // 10, replace=False)
    rows[blips, 3] = 1.0 - rows[blips, 3]
    return rows


class TestPostprocess:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_smooth_rdp_strips_tracker(self, seed):
        rows = _marker_rows(seed)
        flags = tpost.smooth_marker_flags(rows[:, 3])
        _same(flags, jpost.smooth_marker_flags(rows[:, 3]))
        _same(tpost.rdp(rows[:, :2], 0.7), jpost.rdp(rows[:, :2], 0.7))
        rows = rows.copy()
        rows[:, 3] = flags
        trackers = tpost.MarkerTracker(), jpost.MarkerTracker()
        for cut in (len(rows), len(rows) // 3, len(rows) // 7):
            for kw in ({}, dict(polysimp_allow=False, zavg_allow=False)):
                got, gid = tpost.build_line_strips(rows[:cut], **kw)
                want, wid = jpost.build_line_strips(rows[:cut], **kw)
                assert gid == wid and len(got) == len(want) > 0
                for a, b in zip(got, want):
                    assert (a.id, a.color) == (b.id, b.color)
                    _same(a.points, b.points)
                got = trackers[0].finalize(got, gid)
                want = trackers[1].finalize(want, wid)
                assert [(s.id, s.color) for s in got] == [
                    (s.id, s.color) for s in want]
                assert trackers[0].ghostcount == trackers[1].ghostcount


def test_stream_metrics_summary():
    rng = np.random.default_rng(9)
    ms = tmetrics.StreamMetrics(), jmetrics.StreamMetrics()
    for m in ms:
        m.t_start = 100.0
    for i in range(25):
        lat = float(rng.uniform(1, 20))
        parts = dict(latency_ms=lat, dispatch_ms=lat / 4, stage_ms=lat / 4,
                     fetch_ms=lat / 2, post_ms=float(rng.uniform(0, 3)))
        fields = dict(seq=i, ok=bool(i % 7), points_in=1000, points_roi=800,
                      num_rings=30, road_points=500, curb_points=40,
                      marker_count=100, overflow=0, **parts)
        for m, mod in zip(ms, (tmetrics, jmetrics)):
            m.record(mod.ScanStats(**fields))
            if i % 5 == 0:
                m.record_drop()
            if i % 11 == 0:
                m.record_error("bad")
    for m in ms:
        m.t_end = 102.5
    assert ms[0].summary() == ms[1].summary()
    assert tmetrics.ScanStats(**fields).to_json() == jmetrics.ScanStats(
        **fields).to_json()
