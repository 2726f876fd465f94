"""The azimuth-sharded (SP) path over the ranks of a torch.distributed
group, on the CPU: four gloo ranks, spawned once for the module through
torch.multiprocessing (tests/torch_ranks.py, which imports no JAX), meet
through a FileStore under the test's temporary directory; each rank runs
every job in the same order and reports its results.

* RankWedges' methods on each rank's rows of seeded stacks equal
  LocalWedges' on the whole stacks (+-inf in pmax / pmin, bool masks
  through all_gather as uint8, before on the gathered stack); a dtype
  that no collective takes is refused before any collective.
* make_azimuth_pipeline(8 and 4 wedges, group of 4 ranks) is bit-equal on
  every ScanResult field, on every rank, to the one-card path with the
  same wedge count, at tests/test_torch_sp.py's DIMS and CASES, with the
  stencils off, and on a scan whose rings hold more points than a rank's
  wedges have slots; so are the stencils' and markers' global ring
  positions, and the overflow of a scan whose points are all in one
  wedge.  The 4 x 1 run matches the JAX path on a 4-device mesh under
  tests/test_torch_sp.py's classes and tolerance.
* Refusals: n_wedges % world, 360 % n_wedges, and device=None without a
  card.  The collective census of a scan is pinned.
* The replay harness in SP mode over the ranks (rank 0 replays, ranks 1-3
  follow) publishes the one-card SP harness's topics, a mid-run beam_zone
  swap reaches every rank, and close() stops every follower; rank 0's SP
  run and each follower's make one entry, which the swap keeps.
* The group's ``run`` goes through the compiled entries (on the CPU the
  plain twins, with the cache and counts of the card's CUDA graphs), so
  the runs above are its; on every rank it equals ``run.eager`` bit for
  bit, rows and planar, makes one entry per key, none under each of the
  15 dynamic swaps and one under a static change, and leaves after every
  call the census of that call's collectives.  RankWedges.all_gather
  into one tensor gives the list form's bytes; the rank path reads no
  tensor value back to the host (tests/test_torch_sp_jit.py's check).

Every spawned rank ends within the fixture's own time limit (a collective
that waits past the group's timeout ends its rank), so a hang fails the
module instead of stalling the suite.
"""

import queue
import time

import jax
import numpy as np
import pytest
import torch

import torch_ranks as tr
from test_config_dynamic import DYNAMIC_SWAPS
from test_torch_pipeline import (
    _assert_labels_vs_jax, _assert_markers_vs_jax, _envelope)
from urban_road_filter_tpu.config import FilterConfig as JaxConfig
from urban_road_filter_tpu.oracle import run_oracle
from urban_road_filter_tpu.parallel.azimuth_parallel import (
    make_azimuth_pipeline as jax_sp)
from urban_road_filter_tpu.parallel.mesh import make_mesh
from urban_road_filter_torch import ScanResult
from urban_road_filter_torch.config import DynConfig
from urban_road_filter_torch.convert import to_numpy
from urban_road_filter_torch.parallel.azimuth_parallel import (
    LocalWedges, make_azimuth_pipeline)

torch.set_num_threads(1)  # tier-1 runs several pytest workers

LIMIT_S = 420  # every rank reports and exits within this
JAX_CASES = [(scene, c) for scene in ("two_curbs", "blind_spot")
             for c in ("star", "star_off")]  # tests/test_torch_sp.py's CASES


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The four ranks, started; left running ranks are ended at teardown."""
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    store = str(tmp_path_factory.mktemp("ranks") / "store")
    procs = [ctx.Process(target=tr.main, args=(r, tr.WORLD, store, q),
                         daemon=True) for r in range(tr.WORLD)]
    for p in procs:
        p.start()
    yield procs, q, time.monotonic() + LIMIT_S
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(10)


@pytest.fixture(scope="module")
def one_card():
    """The one-card results the ranks' must equal, computed while the
    ranks run: every SP case at 8 and 4 wedges, the overflow scan and the
    SP harness with and without the beam_zone swap."""
    out = {}
    for d in tr.WEDGES:
        for scene, cname in tr.SP_CASES:
            run = make_azimuth_pipeline(d, tr.config(cname), tr.DIMS,
                                        device="cpu")
            out[d, scene, cname] = to_numpy(run(tr.sp_scan(scene)))
    run = make_azimuth_pipeline(8, tr.FilterConfig(), tr.DIMS, device="cpu")
    out["overflow"] = to_numpy(run(tr.one_wedge_scan()))
    out["frame"] = tr.stencil_frame(run)
    out["harness"] = tr.run_harness()
    out["harness_no_swap"] = tr.run_harness(swap=False)
    return out


@pytest.fixture(scope="module")
def ranks(spawned, one_card):
    """{rank: results}: the queue drained, then every rank joined, all
    within LIMIT_S of the spawn."""
    procs, q, deadline = spawned
    got = {}
    while len(got) < len(procs):
        try:
            rank, res = q.get(timeout=max(1.0, deadline - time.monotonic()))
        except queue.Empty:
            pytest.fail(f"ranks {sorted(set(range(tr.WORLD)) - set(got))} "
                        f"did not report within {LIMIT_S} s")
        got[rank] = res
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    assert not any(p.is_alive() for p in procs), "a rank did not exit"
    for rank, res in sorted(got.items()):
        assert "error" not in res, f"rank {rank}:\n{res['error']}"
    assert [p.exitcode for p in procs] == [0] * tr.WORLD
    return got


def _bit_equal(got: ScanResult, want: ScanResult, what: str) -> None:
    for f in ScanResult._fields:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
        if a.dtype.kind == "f":
            a, b = a.view(np.uint32), b.view(np.uint32)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {f}")


METHODS = ("all_gather_f", "all_gather_i", "all_gather_b", "psum_i",
           "psum_f", "pmax_f", "pmin_f", "pmax_i", "pmin_i", "pmax_b",
           "index", "all_index", "before")


@pytest.mark.parametrize("size", tr.WEDGES)
@pytest.mark.parametrize("method", METHODS)
def test_rank_wedges_equal_local_wedges(ranks, size, method):
    """Each rank's RankWedges(size) result on its rows equals LocalWedges'
    on the whole stack: gathers and combines the whole, index and before
    this rank's rows of the whole."""
    want = tr.methods(LocalWedges(size), tr.method_inputs(size))[method]
    local = size // tr.WORLD
    for rank, res in ranks.items():
        got = res[f"methods_{size}"][method]
        mine = (want[rank * local:(rank + 1) * local]
                if method in ("index", "before") else want)
        assert got.dtype == mine.dtype and got.shape == mine.shape
        np.testing.assert_array_equal(got, mine, err_msg=f"rank {rank}")


def test_inputs_hold_infinities_and_masks():
    ins = tr.method_inputs(8)
    assert np.isposinf(ins["f"]).any() and np.isneginf(ins["f"]).any()
    assert ins["b"].any() and not ins["b"].all()


def test_other_dtypes_refused_before_any_collective(ranks):
    for res in ranks.values():
        assert "int64" in res["int64_refused"]


@pytest.mark.parametrize("d", tr.WEDGES)
@pytest.mark.parametrize("scene,cname", tr.SP_CASES)
def test_sp_over_ranks_bit_equal_to_one_card(ranks, one_card, d, scene,
                                             cname):
    """Every rank's whole ScanResult equals the one-card run with the same
    wedge count, bit for bit."""
    want = one_card[d, scene, cname]
    assert bool(want.ok)
    assert (int(want.overflow) > 0) == (scene == "two_curbs_dense")
    for rank, res in ranks.items():
        _bit_equal(ScanResult(*res["sp", d, scene, cname]), want,
                   f"rank {rank} {d} wedges {scene} {cname}")


@pytest.fixture(scope="module")
def jax_runs4():
    """The JAX make_azimuth_pipeline on a 4-device CPU mesh, per case of
    tests/test_torch_sp.py."""
    mesh = make_mesh(n_data=1, n_azimuth=4)
    return {(scene, cname): jax.tree_util.tree_map(
        np.asarray, jax_sp(mesh, JaxConfig(**tr.CONFIGS[cname]), tr.DIMS)(
            tr.sp_scan(scene)))
        for scene, cname in JAX_CASES}


@pytest.mark.parametrize("scene,cname", JAX_CASES)
def test_four_ranks_match_jax_mesh(ranks, jax_runs4, scene, cname):
    """Rank 0's 4 x 1 run against the JAX path over 4 devices, under
    tests/test_torch_sp.py::test_sp_matches_jax's rules: the structural
    fields exact, max_distance to an ulp, labels and markers exact or in
    the classes of tests/test_torch_pipeline.py."""
    cfg = JaxConfig(**tr.CONFIGS[cname])
    got = ScanResult(*ranks[0]["sp", 4, scene, cname])
    want = jax_runs4[scene, cname]
    for f in ("ok", "roi", "num_rings", "ring_id", "counts", "overflow",
              "star_overflow", "probably_road"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    np.testing.assert_array_max_ulp(got.max_distance, want.max_distance,
                                    maxulp=1)
    raw = tr.sp_raw(scene)
    orc = run_oracle(raw, cfg)
    env_runs = _envelope(raw, cfg)
    _assert_labels_vs_jax(got.labels, want.labels, raw, orc.roi_mask, orc,
                          env_runs, f"{scene} {cname} 4 ranks labels")
    _assert_markers_vs_jax(got.markers, want.markers, orc, env_runs,
                           f"{scene} {cname} 4 ranks markers")


def test_overflow_over_ranks(ranks, one_card):
    """Every point in one wedge: the wedge's excess is counted, as on one
    card, and the result equals the one-card run's."""
    n = tr.DIMS.max_points
    want = one_card["overflow"]
    assert int(want.overflow) == n // 4 - n // 8
    for rank, res in ranks.items():
        _bit_equal(ScanResult(*res["overflow"]), want, f"rank {rank}")


def test_ring_positions_over_ranks(ranks, one_card):
    """Each rank's stencil frame (K7's prefix rows and ring totals) and
    K14's g_offset rows equal the one-card run's rows of its wedges: the
    totals are sums of the gathered counts, not psums of them (which would
    count every rank's wedges once per rank)."""
    prefix, total, goff = one_card["frame"]
    for rank, res in ranks.items():
        rows = slice(2 * rank, 2 * rank + 2)
        got = res["frame"]
        np.testing.assert_array_equal(got[0], prefix[rows])
        np.testing.assert_array_equal(got[1], total)
        np.testing.assert_array_equal(got[2], goff[rows])
    assert total.max() > 150


@pytest.mark.parametrize("d,why", [(6, "split evenly over 4 ranks"),
                                   (7, "divide 360")])
def test_refusals(ranks, d, why):
    for res in ranks.values():
        assert why in res["refused", d]


def test_no_device_means_the_card(ranks):
    """device=None with a group is cuda:<rank % cards>: without a card it
    raises, on every rank, and names the CPU as the way to ask for it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for res in ranks.values():
        assert "device='cpu'" in res["no_card"]


def test_collective_census_pinned(ranks):
    """The collectives of one scan at DIMS (8192 points, 64 rings), 8
    wedges over 4 ranks, each rank alike: 3 all_gathers and 11
    all_reduces, 156,656 bytes received per rank (68,608 gathered, 88,048
    reduced; the packed per-point output 32,768 and the blocked bits
    46,336 of them), with the star search on or off; with the stencils
    off the halo's two gathers go, the ring counts' stays.

    The JAX path's census at these dims is 12 all_gathers and 19
    all_reduces (tests/test_azimuth_parallel.py::
    test_sp_collective_sizes_pinned).  The port's is smaller because
    every rank runs the ring discovery (K2) on the whole scan, which the
    JAX path does in a loop of all_gathers; the halo's valid masks go in
    one gather and its six x/y/z blocks in another; the ring counts are
    gathered once for the stencils, the markers and the counts output;
    the blocked bits go as one byte max (an OR), the quadrant extremes as
    one pmax and one pmin, the winners' x/y/z as one psum; labels and
    ring ids as one packed psum, and the ROI mask needs none (every rank
    holds the partition)."""
    for cname, n_ag, n_ar in (("star", 3, 11), ("star_off", 3, 11),
                              ("stencils_off", 1, 11)):
        census = [res["census", 8, "two_curbs", cname]
                  for res in ranks.values()]
        assert all(c == census[0] for c in census), census
        c = census[0]
        assert set(c) == {"all_gather", "all_reduce"}, c
        assert (c["all_gather"]["calls"], c["all_reduce"]["calls"]) == (
            n_ag, n_ar), (cname, c)
        # A ceiling ~10 % above the measured 156,656 bytes.
        total = sum(v["bytes"] for v in c.values())
        assert total <= 168 * 1024, (cname, total)


def _same_topics(got: list, want: list, what: str) -> None:
    assert [o.seq for o in got] == [o.seq for o in want], what
    for a, b in zip(got, want):
        assert a.ok == b.ok, (what, a.seq)
        for f in ("road", "curb", "roi", "road_probably"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.shape == y.shape and np.array_equal(
                x.view(np.int32), y.view(np.int32)), (what, a.seq, f)
        assert len(a.marker_strips) == len(b.marker_strips), (what, a.seq)
        for u, v in zip(a.marker_strips, b.marker_strips):
            assert (u.id, u.color) == (v.id, v.color), (what, a.seq)
            assert np.array_equal(u.points, v.points), (what, a.seq)


def test_harness_over_ranks_publishes_the_one_card_topics(ranks, one_card):
    """The SP harness over 4 ranks (rank 0 replaying the PCD fixtures and
    three scans, ranks 1-3 following) publishes the one-card SP
    harness's topics, scan for scan, the beam_zone swap included."""
    got = ranks[0]["harness"]
    assert len(got) == len(tr.harness_scans()) == 6
    assert all(o.ok for o in got)
    _same_topics(got, one_card["harness"], "harness over 4 ranks")


def test_config_swap_reaches_every_rank(ranks, one_card):
    """After the swap the scans differ from an unswapped run: the new
    beam_zone was in force on every rank's wedges, or the ranked run
    would not equal the one-card swapped run (previous test)."""
    swapped, plain = one_card["harness"], one_card["harness_no_swap"]
    _same_topics(swapped[:tr.SWAP_AT + 1], plain[:tr.SWAP_AT + 1],
                 "before the swap")
    assert any(not np.array_equal(a.road, b.road) for a, b in
               zip(swapped[tr.SWAP_AT + 1:], plain[tr.SWAP_AT + 1:]))


def test_followers_stop_after_every_scan(ranks):
    """Each follower ran every scan rank 0 sent and returned on the stop."""
    for rank in range(1, tr.WORLD):
        assert ranks[rank]["followed"] == len(tr.harness_scans())


def test_ranks_import_no_jax(ranks):
    assert all(res["jax_free"] for res in ranks.values())


# --- the group's run through the compiled entries (on the CPU, the plain
# twins through the same cache and counts as on one card) ---

def test_group_run_compiles_by_backend(ranks):
    """Over a gloo group on the CPU ``run`` goes through the entries; on a
    card a gloo group's would be ``run.eager`` (decided from the backend
    when the pipeline is made)."""
    for res in ranks.values():
        assert res["backend_compiles"] == (True, True, False)


@pytest.mark.parametrize("layout", ["rows", "planar"])
@pytest.mark.parametrize("d", tr.WEDGES)
@pytest.mark.parametrize("scene,cname", tr.SP_CASES)
def test_compiled_equals_eager_over_ranks(ranks, one_card, d, scene, cname,
                                          layout):
    """On every rank the compiled run equals run.eager bit for bit on every
    field, rows and planar, and both equal the one-card run."""
    want = one_card[d, scene, cname]
    for rank, res in ranks.items():
        got, _ = res["calls", d, scene, cname]["compiled", layout]
        eager, _ = res["calls", d, scene, cname]["eager", layout]
        what = f"rank {rank} {d} wedges {scene} {cname} {layout}"
        _bit_equal(ScanResult(*got), ScanResult(*eager), what)
        _bit_equal(ScanResult(*got), want, what)


def test_one_entry_per_key_over_ranks(ranks):
    """Rows, rows again and planar: two entries on every rank, each counted
    once in CAPTURE_COUNTS["sp"]."""
    for rank, res in ranks.items():
        for d in tr.WEDGES:
            for scene, cname in tr.SP_CASES:
                assert res["captures", d, scene, cname] == (2, 2), (
                    rank, d, scene, cname)


def test_census_after_every_call_over_ranks(ranks):
    """After every call, a CPU entry's or run.eager's, rows or planar,
    run.wedges.census holds that call's collectives: the eager census."""
    for rank, res in ranks.items():
        for d in tr.WEDGES:
            for scene, cname in tr.SP_CASES:
                want = res["census", d, scene, cname]
                assert want and all(
                    c == want for _, c in
                    res["calls", d, scene, cname].values()), (
                        rank, d, scene, cname)


def test_swaps_are_every_dynamic_field():
    assert tr.DYNAMIC_SWAPS == DYNAMIC_SWAPS
    assert len(tr.DYNAMIC_SWAPS) == len(DynConfig._fields)


@pytest.mark.parametrize("swap", list(tr.SWAPS))
def test_dynamic_swap_over_ranks(ranks, swap):
    """Each dynamic field swapped alone, and all at once, on the warm
    entry of every rank: run.eager's result under the new configuration,
    no capture and no entry."""
    for rank, res in ranks.items():
        got, eager, captures, entries = res["swaps"][swap]
        _bit_equal(ScanResult(*got), ScanResult(*eager),
                   f"rank {rank} {swap}")
        assert (captures, entries) == (0, 0), (rank, swap)


def test_swaps_take_effect_over_ranks(ranks):
    base = ScanResult(*ranks[0]["sp", 8, "two_curbs", "star"])
    assert any(not np.array_equal(ScanResult(*got).labels, base.labels)
               for got, _, _, _ in ranks[0]["swaps"].values())


def test_static_change_over_ranks(ranks):
    """A static change (blind_spots off) makes one entry on every rank."""
    for rank, res in ranks.items():
        got, eager, captures, entries = res["swaps"]["static"]
        _bit_equal(ScanResult(*got), ScanResult(*eager), f"rank {rank}")
        assert (captures, entries) == (1, 1), rank


@pytest.mark.parametrize("size", tr.WEDGES)
def test_all_gather_into_one_tensor_equals_list_form(ranks, size):
    """RankWedges.all_gather (one (world * local, ...) tensor) gives the
    bytes of dist.all_gather's list form concatenated, in global wedge
    order, on every rank."""
    ins = tr.method_inputs(size)
    for rank, res in ranks.items():
        for k, (one, listed) in res[f"gather_forms_{size}"].items():
            assert one.shape == listed.shape == ins[k].shape, (rank, k)
            assert one.astype(listed.dtype).tobytes() == listed.tobytes()
            np.testing.assert_array_equal(one, ins[k], err_msg=f"{rank} {k}")


@pytest.mark.parametrize("mode", ["compiled", "eager"])
@pytest.mark.parametrize("cname", ["star", "star_off"])
def test_rank_glue_reads_nothing_back(ranks, cname, mode):
    """tests/test_torch_sp_jit.py's host-read check on each rank: the
    rank path (its collectives included) reads no tensor value back to
    the host, apart from the plain star walk's step count (a CPU twin that
    on the card is K4)."""
    for rank, res in ranks.items():
        seen = res["host_reads", cname][mode]
        glue = [(op, frames[-3:]) for op, frames in seen
                if "star_walk_plain" not in frames]
        assert not glue, (rank, glue[:5])
        if cname == "star_off":
            assert not seen, rank


def test_harness_ranks_make_one_entry(ranks):
    """Rank 0's SP run and each follower's make one entry, on the first
    scan, and keep it across the mid-run beam_zone swap (the topics of
    the two harness tests above)."""
    for rank, res in ranks.items():
        assert res["harness_captures"] == 1, rank
