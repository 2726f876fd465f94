"""The port's compiled entry points and their configuration hot swap, on
the CPU: the counterpart of tests/test_config_dynamic.py.

process_scan_jit, packed_scan_jit and process_batch_jit keep one entry per
(static half of the configuration, dims, layout, input shape and dtype,
entry class, device), with a parameter buffer of its own that the stages
read (on the card a CUDA graph captured once and replayed; here the plain
twins on the same buffer).  A change of any of the 15 dynamic fields must reuse the
entry (CAPTURE_COUNTS unchanged) and take effect: every output equals the
eager entry point's under the new configuration bit for bit, and the JAX
package's jitted entry points exactly or within the classes of
tests/test_torch_pipeline.py (0 unexplained flips: XLA's jitted CPU code
fuses multiply-adds).  A change of a static field makes one new entry.
make_sharded_pipeline's ``cfg_now`` swap makes none and changes the
labels.  On the card chip_smoke.py phase 9 runs the same swaps through the
graphs.  The batch entry's lane groups (a batch from pinned host memory):
its body over the groups equals the body over the whole batch, and the
rule that picks it (tests/test_torch_kernels_gpu.py runs it on the card).
"""

import numpy as np
import pytest
import torch

from conftest import assert_label_parity
from test_config_dynamic import DIMS as JAX_DIMS
from test_config_dynamic import DYNAMIC_SWAPS, STATIC_SWAPS
from test_torch_pipeline import _assert_labels_vs_jax, _envelope
from urban_road_filter_tpu import pipeline as jpl
from urban_road_filter_tpu.config import FilterConfig as JFilterConfig
from urban_road_filter_tpu.oracle import run_oracle
from urban_road_filter_torch import (
    FilterConfig, PipelineDims, pad_scan, packed_scan_jit, process_batch,
    process_batch_jit, process_scan_jit)
from urban_road_filter_torch import config as C
from urban_road_filter_torch import pipeline as pl
from urban_road_filter_torch.io import SCENES, make_scan
from urban_road_filter_torch.parallel.data_parallel import (
    make_sharded_pipeline)

torch.set_num_threads(1)  # tier-1 runs several pytest workers

DIMS = PipelineDims(**JAX_DIMS.__dict__)
KINDS = ("scan", "packed", "batch")
SWAPS = {**{k: {k: v} for k, v in DYNAMIC_SWAPS.items()},
         "all": dict(DYNAMIC_SWAPS), "default": {}}


@pytest.fixture(scope="module")
def scan():
    return make_scan(SCENES["two_curbs"](), n_rings=24, n_azimuth=384, seed=5)


@pytest.fixture(scope="module")
def pts(scan):
    return pad_scan(scan, DIMS.max_points)


@pytest.fixture(scope="module")
def batch(scan, pts):
    other = make_scan(SCENES["blind_spot"](), n_rings=24, n_azimuth=384,
                      seed=6)
    return np.stack([pts, pad_scan(other, DIMS.max_points)]), [scan, other]


@pytest.fixture(scope="module")
def warm(pts, batch):
    """Every kind's entries at the default configuration, made once: the
    batch of two lanes and of one."""
    for kind in KINDS:
        for stack in (batch[0], batch[0][:1]):
            _call(kind, (pts, stack), FilterConfig())


def _call(kind, inputs, cfg):
    pts, batch = inputs
    if kind == "scan":
        return process_scan_jit(pts, cfg, DIMS, device="cpu")
    if kind == "packed":
        return packed_scan_jit(pts, cfg, DIMS, device="cpu")
    return process_batch_jit(batch, cfg, DIMS, device="cpu")


def _same(got, want, what):
    assert type(got) is type(want), what
    for k, (a, b) in enumerate(zip(got, want)):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert a.shape == b.shape and torch.equal(a, b), (what, k)


@pytest.mark.parametrize("name", sorted(STATIC_SWAPS))
@pytest.mark.parametrize("kind", KINDS)
def test_static_swap_captures_once(kind, name, pts, batch, warm):
    inputs = (pts, batch[0][:1])
    before = pl.CAPTURE_COUNTS[kind]
    _call(kind, inputs, FilterConfig(**{name: STATIC_SWAPS[name]}))
    assert pl.CAPTURE_COUNTS[kind] == before + 1, name
    _call(kind, inputs, FilterConfig(beam_zone=42.5))
    assert pl.CAPTURE_COUNTS[kind] == before + 1, name


@pytest.mark.parametrize("swap", list(SWAPS))
def test_swapped_values_take_effect(swap, scan, pts, batch, warm):
    """Each dynamic field swapped alone, all at once, and back to the
    default, on the warm entries: no kind makes a new entry, every output
    equals the eager entry point's bit for bit, and the JAX package's
    jitted entry points' exactly or within the classes."""
    cfg, jcfg = FilterConfig(**SWAPS[swap]), JFilterConfig(**SWAPS[swap])
    raw, (stack, scans) = pts, batch
    counts = dict(pl.CAPTURE_COUNTS)
    # process_scan's and packed_scan's results, from one eager run.
    eager, plane = pl._scan(torch.from_numpy(raw), cfg, DIMS, "rows", "cpu")
    res = process_scan_jit(raw, cfg, DIMS, device="cpu")
    _same(res, eager, "scan")
    packed = packed_scan_jit(raw, cfg, DIMS, device="cpu")
    _same(packed, (plane, eager.markers, eager.ok, eager.num_rings,
                   eager.overflow), "packed")
    out = process_batch_jit(stack, cfg, DIMS, device="cpu")
    _same(out, process_batch(torch.from_numpy(stack), cfg, DIMS,
                             device="cpu"), "batch")
    assert pl.CAPTURE_COUNTS == counts

    jx = jpl.process_scan_jit(raw, jcfg, JAX_DIMS)
    jpacked = jpl.packed_scan_jit(raw, jcfg, JAX_DIMS)
    jbatch = jpl.process_batch_jit(stack, jcfg, JAX_DIMS)
    np.testing.assert_array_equal(res.roi.numpy(), np.asarray(jx.roi))
    assert int(res.num_rings) == int(jx.num_rings)
    np.testing.assert_array_equal(packed[0].numpy() >> 2,
                                  np.asarray(jpacked[0]) >> 2)
    lanes = [(res.labels.numpy(), np.asarray(jx.labels), scans[0], "scan"),
             (packed[0].numpy() & 3, np.asarray(jpacked[0]) & 3, scans[0],
              "packed")]
    lanes += [(out.labels[b].numpy(), np.asarray(jbatch.labels[b]),
               scans[b], f"batch lane {b}") for b in range(len(scans))]
    for got, want, scan_b, what in lanes:
        got, want = got.astype(np.int8), want.astype(np.int8)
        assert_label_parity(got, want, 0.999, f"{swap} {what}")
        if not np.array_equal(got, want):  # classify the flips
            orc = run_oracle(scan_b, cfg)
            _assert_labels_vs_jax(got, want, scan_b, orc.roi_mask, orc,
                                  _envelope(scan_b, cfg), f"{swap} {what}")


@pytest.mark.parametrize("kind", KINDS)
def test_mid_stream_swap_sequence(kind, pts, batch, warm):
    """The demo's live swap: default -> tight ROI -> default, one entry."""
    inputs = (pts, batch[0][:1])
    a = _call(kind, inputs, FilterConfig())
    before = dict(pl.CAPTURE_COUNTS)
    b = _call(kind, inputs, FilterConfig(max_x=12.0))
    c = _call(kind, inputs, FilterConfig())
    roi = (lambda r: r.roi) if kind != "packed" else (
        lambda r: (r[0] & 4) != 0)
    assert int(roi(b).sum()) < int(roi(a).sum())
    _same(c, a, kind)
    assert pl.CAPTURE_COUNTS == before


def test_results_are_new_tensors(pts):
    """A result is never overwritten by the next call (the JAX entries'
    contract)."""
    a = process_scan_jit(pts, FilterConfig(), DIMS, device="cpu")
    keep = [t.clone() for t in a]
    process_scan_jit(pts, FilterConfig(max_x=12.0), DIMS, device="cpu")
    _same(a, type(a)(*keep), "first result")


def test_entry_reads_its_parameter_buffer(pts):
    """The entry's stages read its own buffer: after a swap it holds the
    new values' packing, and its bound config's fields are views of it."""
    cfg = FilterConfig(beam_zone=42.5, dmin_param=8)
    process_scan_jit(pts, cfg, DIMS, device="cpu")
    key = ("scan", cfg.split()[0], DIMS, "rows", tuple(pts.shape),
           torch.float32, pl._Compiled, torch.device("cpu"))
    entry = pl.compiled_entries()[key]
    want = torch.from_numpy(C.pack_dyn(cfg.split()[1]))
    assert torch.equal(entry.params.view(torch.int32),
                       want.view(torch.int32))
    assert entry.cfg.beam_zone.data_ptr() == (
        entry.params.data_ptr() + 4 * C.DYN_INDEX["beam_zone"])
    assert int(entry.cfg.dmin_param) == 8
    assert entry.cfg.dmin_param.dtype == torch.int32


def test_parameter_buffer_cache():
    """One buffer per configuration value and device: a run of scans under
    one configuration makes none after the first (so, on the card, no
    host-to-device copy per scan); a new value makes one."""
    cfg = FilterConfig(curb_height=0.0875)
    a = C.device_config(cfg, "cpu")
    assert C.device_config(FilterConfig(curb_height=0.0875), "cpu") is a
    assert C.device_config(a, "cpu") is a
    buf = C.param_buffer(cfg.split()[1], "cpu")
    assert buf is a.params
    assert C.param_buffer(FilterConfig(curb_height=0.0876).split()[1],
                          "cpu") is not buf
    st, dyn = cfg.split()
    for name, i in C.DYN_INDEX.items():
        if name == C.DYN_INT:
            assert int(buf.view(torch.int32)[i]) == int(dyn.dmin_param)
        else:
            assert float(buf[i]) == float(np.float32(getattr(dyn, name)))
    assert a.static == st and a.curb_points == cfg.curb_points


@pytest.mark.parametrize("n_devices", [1, 2])
def test_sharded_swap_no_capture(n_devices, batch):
    """make_sharded_pipeline runs process_batch_jit per chunk: its
    cfg_now swap adds no capture and changes the labels, equal to
    process_batch under the new configuration."""
    stack = batch[0]
    run = make_sharded_pipeline(["cpu"] * n_devices, FilterConfig(), DIMS)
    out1 = run(stack)
    before = dict(pl.CAPTURE_COUNTS)
    out2 = run(stack, FilterConfig(max_x=12.0))
    assert pl.CAPTURE_COUNTS == before
    assert not torch.equal(out1.labels, out2.labels)
    _same(out2, process_batch(torch.from_numpy(stack),
                              FilterConfig(max_x=12.0), DIMS, device="cpu"),
          "sharded")


@pytest.fixture(scope="module")
def eight_lanes(pts):
    """(8, N, 4) rows of scans that differ: three scenes, two seeds each,
    an empty lane and a lane under the 30-point gate."""
    scans = [make_scan(SCENES[s](), n_rings=24, n_azimuth=384, seed=k)
             for s in ("two_curbs", "blind_spot", "curb_gap")
             for k in (7, 8)]
    scans += [np.zeros((0, 4), np.float32),
              np.tile(np.float32([[1, 0, -2, 0]]), (10, 1))]
    return torch.from_numpy(np.stack([pad_scan(s, DIMS.max_points)
                                      for s in scans]))


@pytest.mark.parametrize("b,group,layout", [(8, 2, "rows"),
                                            (8, 4, "planar"),
                                            (7, 2, "rows")])
def test_lane_groups_equal_the_whole_batch(b, group, layout, eight_lanes):
    """The pinned batch entry's body (pipeline._LaneGroups) on the plain
    twins: the stages over each lane group of the batch (ceil(b / group)
    groups, the last one short where group does not divide b), each
    group's outputs written into its lanes of new (b, ...) fields, are
    bit-equal on every ScanResult field to the stages over the whole
    batch."""
    rows = eight_lanes[:b]
    pts = rows if layout == "rows" else torch.from_numpy(
        pl.planarize_batch(rows.numpy()))
    cfg = C.device_config(FilterConfig(), "cpu")
    groups = pl.lane_groups(b, group)
    assert len(groups) == -(-b // group) and groups[-1][1] == b
    assert [hi - lo for lo, hi in groups][:-1] == [group] * (len(groups) - 1)
    got = pl._joined(pl._batch_groups(pl._batch_on, pts, cfg, DIMS, layout,
                                      groups))
    want = pl._batch_on(pts, cfg, DIMS, layout)
    assert got._fields == want._fields
    _same(got, want, f"{b} lanes in groups of {group}")
    assert got.ok.tolist() == [True] * 6 + [False] * (b - 6)


@pytest.mark.parametrize("on_host,pinned,lanes,group,want", [
    (True, True, 32, 16, True),
    (True, True, 128, 16, True),
    (True, True, 7, 2, True),
    (True, True, 31, 16, False),   # fewer than two groups
    (True, True, 16, 16, False),
    (True, False, 128, 16, False),  # pageable
    (False, False, 128, 16, False),  # on the card already
])
def test_grouped_copy_in_rule(on_host, pinned, lanes, group, want):
    """The batch entry copies in by lane groups only from pinned host
    memory and with at least two groups; everything else, and every
    entry on the CPU, takes the whole-batch copy."""
    assert pl.grouped_copy_in(on_host, pinned, lanes, group) is want
    batch = torch.zeros((2 * pl.LANE_GROUP, 8, 4))
    assert pl._batch_entry(batch, "rows", "cpu") is pl._Compiled
    assert pl._batch_entry(batch.numpy(), "rows", "cpu") is pl._Compiled
