"""The port's batched gather + pack (ops/gather.py: K11 gather_pack_batch,
one launch per 128 lanes on the card) and the batch path that calls it
once per batch, against the JAX package, on the CPU.

The plain twin runs here; the same numpy inputs go to it and to the JAX
package's gather_by_group_pos as its pipeline calls it
(urban_road_filter_tpu/pipeline.py:195-197: pack=4, i8=True, g_mult=8),
in interpret mode under vmap over the lanes as its batch path runs it,
then gated and packed as at pipeline.py:199-212 and :272-277.  Bit-equal
on every point, with two exceptions of the reference that the port does
not copy: its i8 path can decode a negative ring id or slot to a
spurious label (ops/gather.py:113; the port reads 0, as the JAX
package's off-TPU formulation does), and it flags probably-road points on
the "no ring" id when probably_road_ring equals the ring count (the port
flags none).  Also: process_batch with one lane under the 30-point gate
against process_scan lane by lane and against process_batch_jit, and
numpy models of how the kernels split a lane into 4-point vectors and
single points (csrc/gather_pack.cu, csrc/ingest.cu).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from urban_road_filter_tpu.config import FilterConfig, PipelineDims
from urban_road_filter_tpu.io.synthetic import SCENES, make_scan
from urban_road_filter_tpu.ops.gather import (
    gather_by_group_pos as jgather)
from urban_road_filter_tpu.oracle import run_oracle
from urban_road_filter_tpu.pipeline import planarize_batch as jplanarize
from urban_road_filter_tpu.pipeline import process_batch_jit
from urban_road_filter_torch import (
    ScanResult, pad_scan, planarize_batch, process_batch, process_scan)
from urban_road_filter_torch.convert import to_numpy
from urban_road_filter_torch.ops.gather import (
    LANES, gather_pack, gather_pack_batch, gather_pack_batch_plain)
from test_torch_pipeline import _assert_labels_vs_jax, _envelope

torch.set_num_threads(1)  # tier-1 runs several pytest workers

R, P, N = 24, 256, 603  # N % 4 != 0
PRR = 10


def _lanes(b, seed):
    """b lanes of label tables in {0, 1, 2}, ring ids and slots partly
    outside the table (negative ones too), ROI flags, and the gate off on
    lane 1 (when b > 1)."""
    rng = np.random.default_rng(seed)
    tables = rng.integers(0, 3, (b, R, P)).astype(np.int32)
    ids = rng.integers(-3, R + 3, (b, N)).astype(np.int32)
    pos = rng.integers(-3, P + 3, (b, N)).astype(np.int32)
    ids[:, :6] = [-1, -2, 0, R, R - 1, PRR]
    pos[:, :6] = [3, 7, -1, 0, P, 5]
    valid = rng.random((b, N)) < 0.7
    ok = np.ones(b, bool)
    if b > 1:
        ok[1] = False
    return tables, ids, pos, valid, ok


def _jax_lanes(tables, ids, pos, valid, ok, prr):
    """The JAX package's per-point outputs of each lane: the gather as its
    pipeline calls it, vmapped over the lanes, gated and packed."""
    gather = jax.vmap(lambda t, i, p: jgather(
        t, i, p, interpret=True, pack=4, i8=True, g_mult=8))
    lab = np.asarray(gather(jnp.asarray(tables, jnp.float32),
                            jnp.asarray(ids), jnp.asarray(pos))).astype(
                                np.int32)
    gate = ok[:, None]
    lab = np.where(gate, lab, 0).astype(np.int8)
    roi = valid & gate
    pr = (ids == prr) & gate
    packed = (lab.astype(np.uint8) | roi.astype(np.uint8) << 2
              | pr.astype(np.uint8) << 3)
    return lab, roi, pr, packed


def _port(tables, ids, pos, valid, ok, prr):
    return [t.numpy() for t in gather_pack_batch(
        [torch.from_numpy(t) for t in tables], torch.from_numpy(ids),
        [torch.from_numpy(p) for p in pos], torch.from_numpy(valid),
        torch.from_numpy(ok), prr)]


@pytest.mark.parametrize("b", [1, 3, LANES + 2])
def test_batch_twin_matches_jax(b):
    tables, ids, pos, valid, ok = _lanes(b, seed=b)
    got = _port(tables, ids, pos, valid, ok, PRR)
    want = _jax_lanes(tables, ids, pos, valid, ok, PRR)
    assert [g.shape for g in got] == [(b, N)] * 4
    assert [g.dtype for g in got] == [np.int8, np.bool_, np.bool_, np.uint8]
    # The reference's i8 decode is exact except on a negative index.
    neg = (ids < 0) | (pos < 0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[~neg], w[~neg])
    np.testing.assert_array_equal(got[1], want[1])  # ROI: no lookup
    np.testing.assert_array_equal(got[2], want[2])  # PRR is a ring
    # A negative index reads 0 in the port, as in the JAX package's off-TPU
    # formulation; the interpreted kernel does not always.
    assert not got[0][neg].any()
    off_tpu = np.stack([np.asarray(jgather(
        jnp.asarray(t, jnp.float32), jnp.asarray(i), jnp.asarray(p)))
        for t, i, p in zip(tables, ids, pos)]).astype(np.int8)
    np.testing.assert_array_equal(got[0], np.where(ok[:, None], off_tpu, 0))
    if b > 1:  # the gated-off lane publishes nothing
        assert not any(g[1].any() for g in got)
        assert got[0][0].any() and got[3][2].any()


def test_vmapped_reference_is_the_per_lane_call():
    # The reference above runs under vmap, as the JAX batch path does; per
    # lane, as pipeline.py:195-197 calls it for one scan, it is the same.
    tables, ids, pos, valid, ok = _lanes(3, seed=7)
    batch = _jax_lanes(tables, ids, pos, valid, ok, PRR)[0]
    for b in range(3):
        one = np.asarray(jgather(jnp.asarray(tables[b], jnp.float32),
                                 jnp.asarray(ids[b]), jnp.asarray(pos[b]),
                                 interpret=True, pack=4, i8=True,
                                 g_mult=8)).astype(np.int8)
        np.testing.assert_array_equal(batch[b], np.where(ok[b], one, 0))


def test_probably_road_ring_is_rings():
    """probably_road_ring == R, the "no ring" id: the port flags no point;
    the JAX package flags every point on that id (ROADMAP Queue 3)."""
    tables, ids, pos, valid, ok = _lanes(3, seed=11)
    got = _port(tables, ids, pos, valid, ok, R)
    want = _jax_lanes(tables, ids, pos, valid, ok, R)
    assert not got[2].any() and not (got[3] & 8).any()
    assert want[2].any()
    ring = (ids >= 0) & (pos >= 0)
    np.testing.assert_array_equal(got[0][ring], want[0][ring])
    np.testing.assert_array_equal(got[3][ring] & 7, want[3][ring] & 7)


@pytest.mark.parametrize("b", [1, 3])
def test_single_scan_call_is_lane_zero(b):
    # gather_pack of one scan equals its lane of gather_pack_batch.
    tables, ids, pos, valid, ok = _lanes(b, seed=20 + b)
    got = _port(tables, ids, pos, valid, ok, PRR)
    for k in range(b):
        one = gather_pack(torch.from_numpy(tables[k]),
                          torch.from_numpy(ids[k]), torch.from_numpy(pos[k]),
                          torch.from_numpy(valid[k]),
                          torch.tensor(bool(ok[k])), PRR)
        for g, w in zip(got, one):
            np.testing.assert_array_equal(g[k], w.numpy())


def test_batch_twin_is_per_lane_twin():
    tables, ids, pos, valid, ok = _lanes(5, seed=3)
    got = gather_pack_batch_plain(
        [torch.from_numpy(t) for t in tables], torch.from_numpy(ids),
        [torch.from_numpy(p) for p in pos], torch.from_numpy(valid),
        torch.from_numpy(ok), PRR)
    for k in range(5):
        one = gather_pack(torch.from_numpy(tables[k]),
                          torch.from_numpy(ids[k]), torch.from_numpy(pos[k]),
                          torch.from_numpy(valid[k]),
                          torch.tensor(bool(ok[k])), PRR)
        for g, w in zip(got, one):
            assert torch.equal(g[k], w)


def test_mismatched_lanes_raise():
    tables, ids, pos, valid, ok = _lanes(3, seed=1)
    with pytest.raises(ValueError):
        gather_pack_batch([torch.from_numpy(t) for t in tables],
                          torch.from_numpy(ids),
                          [torch.from_numpy(p) for p in pos[:2]],
                          torch.from_numpy(valid), torch.from_numpy(ok), PRR)


# The batch path: one gather over the batch, lanes equal to process_scan.

DIMS = PipelineDims(max_points=8192, rings=32, ring_capacity=512)


@pytest.fixture(scope="module")
def short_lane_batch():
    """Three scenes and, in lane 1, a scan with 20 points in the ROI (the
    >= 30-point gate is off there alone), as (B, N, 4) rows."""
    scans = [make_scan(SCENES[s](), n_rings=24, n_azimuth=256, seed=30 + i)
             for i, s in enumerate(("curb_gap", "flat", "blind_spot"))]
    short = np.tile(np.float32([[5.0, 1.0, -2.0, 0.0]]), (200, 1))
    short[20:, 2] = 3.0  # above the ROI
    short[:20, 0] += np.arange(20, dtype=np.float32) * 0.1
    rows = [pad_scan(s, DIMS.max_points) for s in (scans[0], short,
                                                   *scans[1:])]
    return np.stack(rows), [scans[0], short, *scans[1:]]


@pytest.mark.parametrize("cfg", [FilterConfig(),
                                 FilterConfig(star_shaped_method=False)],
                         ids=["star", "star_off"])
def test_short_lane_batch_equals_process_scan(short_lane_batch, cfg):
    rows, _ = short_lane_batch
    got = to_numpy(process_batch(torch.from_numpy(planarize_batch(rows)),
                                 cfg, DIMS, layout="planar", device="cpu"))
    assert got.ok.tolist() == [True, False, True, True]
    for k, pts in enumerate(rows):
        one = to_numpy(process_scan(torch.from_numpy(pts), cfg, DIMS,
                                    device="cpu"))
        for f in ScanResult._fields:
            np.testing.assert_array_equal(getattr(got, f)[k],
                                          getattr(one, f),
                                          err_msg=f"lane {k} {f}")
    assert not got.labels[1].any() and not got.roi[1].any()
    assert not got.probably_road[1].any() and not got.markers[1].any()


def test_short_lane_batch_matches_jax(short_lane_batch):
    rows, scans = short_lane_batch
    cfg = FilterConfig()
    got = to_numpy(process_batch(torch.from_numpy(planarize_batch(rows)),
                                 cfg, DIMS, layout="planar", device="cpu"))
    jx = ScanResult(*(np.asarray(f) for f in process_batch_jit(
        jplanarize(rows), cfg, DIMS)))
    for f in ("ok", "roi", "num_rings", "counts", "overflow"):
        np.testing.assert_array_equal(getattr(got, f), getattr(jx, f),
                                      err_msg=f)
    np.testing.assert_array_equal(got.labels[1], jx.labels[1])
    np.testing.assert_array_equal(got.probably_road[1], jx.probably_road[1])
    np.testing.assert_array_equal(got.markers[1], jx.markers[1])
    same_ring = got.ring_id == jx.ring_id
    assert same_ring.mean() >= 0.9999
    np.testing.assert_array_equal(got.probably_road[same_ring],
                                  jx.probably_road[same_ring])
    for k in (0, 2, 3):
        pts = scans[k]
        orc = run_oracle(pts, cfg)
        _assert_labels_vs_jax(got.labels[k], jx.labels[k], pts,
                              orc.roi_mask, orc, _envelope(pts, cfg),
                              f"lane {k} labels")


# Models of the kernels' split of a lane into 4-point vectors and single
# points: every point exactly once, whatever the streams' offsets.

def _head(offsets_bytes_sizes):
    """csrc/*.cu common head: the first index from which every stream
    (byte offset, element size) sits on a 4-element boundary, None if
    they share none."""
    heads = set()
    for off, size in offsets_bytes_sizes:
        if off % size:
            return None
        heads.add(((4 * size - off % (4 * size)) % (4 * size)) // size)
    return heads.pop() if len(heads) == 1 else None


def _split(n, head, guard=0):
    """(vector starts, single points) of one lane, as the kernels loop."""
    head = n if head is None or head > n else head
    nvec = max(n - head - guard, 0) >> 2
    vecs = [head + 4 * q for q in range(nvec)]
    singles = [t if t < head else t + 4 * nvec for t in range(n - 4 * nvec)]
    return vecs, singles


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 603, 4097])
@pytest.mark.parametrize("guard", [0, 1])
def test_vector_split_covers_each_point_once(n, guard):
    for lane in range(4):
        for pos_off in (0, 4, 8, 12, 2):
            head = _head([(4 * lane * n, 4), (pos_off, 4), (lane * n, 1)])
            vecs, singles = _split(n, head, guard)
            seen = sorted([i + e for i in vecs for e in range(4)] + singles)
            assert seen == list(range(n)), (lane, pos_off)
            if head is not None:
                assert all((4 * lane * n + 4 * i) % 16 == 0 for i in vecs)
                assert all((lane * n + i) % 4 == 0 for i in vecs)
            if guard and n:
                assert n - 1 in singles  # K1's rows of 4: the last point
