"""The rule of the flood-fill road mask kernels (K9 flood_labeled, K12
flood_road), on the CPU.

The CUDA kernel (csrc/flood.cu, labeled_kernel) runs only on the card, so
its design is held here as a numpy model, step for step: for a slot of ring
k with a valid azimuth a, the forward starts that cover it are the interval
[i0, floor(a)], i0 the first start with a <= fl(i + w_k), found by nine
halving steps; the backward ones [ceil(a), i1], i1 the last start with
fl(i - w_k) <= a; a reached start in an interval is a difference of
prefix counts of the reach bits; the special starts (360 - bz forward, bz
backward, rings >= 1) are tested on their own.  Every add is an np.float32
add, rounded as the twin rounds it.

The model must equal ``flood_road_plain`` and ``flood_labeled_plain`` (the
dense compare-reduce over all 362 starts) bit for bit: on chip_smoke.py's
``flood_cases`` (the inputs the card's kernels are held on), on window
widths 0, 1e-30, 1, 37.5, 361, 1e30, inf and NaN with azimuths on and one
ulp beside every window end, and on a hypothesis sweep.  The twins are held
against the JAX package's eager formulation (``labeled_mask`` over
``sweep_bounds``) on the same inputs.  Exact equality throughout: no step
rounds differently on either side.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from urban_road_filter_tpu.ops import blind_spots as jbs
from urban_road_filter_torch.ops import blind_spots as bs
from urban_road_filter_torch.ops.geometry import RingLayout
from urban_road_filter_torch.ops.markers import NO_KEY

torch.set_num_threads(1)  # tier-1 runs several pytest workers

F32 = np.float32
STARTS = 362
WIDTHS = (0.0, 1e-30, 1.0, 37.5, 361.0, 1e30, np.inf, np.nan)


def _smoke():
    """chip_smoke.py as a module: its flood_cases."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", pathlib.Path(__file__).parents[1] /
        "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _halving(holds, shape):
    """The number of starts 0..361 in the prefix where ``holds`` is true,
    in the kernel's nine halving steps (first_forward, backward_end)."""
    n = np.zeros(shape, np.int64)
    for step in (256, 128, 64, 32, 16, 8, 4, 2, 1):
        fits = n + step <= STARTS
        probe = np.where(fits, n + step - 1, 0).astype(F32)
        n = np.where(fits & holds(probe), n + step, n)
    return n


def model_road(alpha, counts, w, reach_f, reach_b, bz):
    """(R, P) bool road mask by the interval rule."""
    r, p = alpha.shape
    bz = F32(bz)
    sp = F32(F32(360.0) - bz)
    slot = np.arange(p)
    road = np.zeros((r, p), bool)
    with np.errstate(invalid="ignore", over="ignore"):
        for k in range(r):
            wk = F32(w[k])
            ok = ((slot < counts[k]) & (alpha[k] >= 0)
                  & (alpha[k] <= F32(360.0)))
            a = np.where(ok, alpha[k], F32(0.0))
            pre_f = np.concatenate([[0], np.cumsum(reach_f[k])])
            pre_b = np.concatenate([[0], np.cumsum(reach_b[k])])
            i0 = _halving(lambda i: ~(a <= i + wk), p)
            end = _halving(lambda i: i - wk <= a, p)
            hi = np.floor(a).astype(np.int64)
            lo = np.ceil(a).astype(np.int64)
            fwd = (i0 <= hi) & (pre_f[hi + 1] > pre_f[i0])
            bwd = (lo <= end - 1) & (pre_b[end] > pre_b[lo])
            if k >= 1 and 0 <= sp <= 361 and sp == np.floor(sp):
                fwd |= reach_f[k, int(sp)] & (sp <= a)
            if k >= 1 and 0 <= bz <= 361 and bz == np.floor(bz):
                bwd |= reach_b[k, int(bz)] & (a <= bz)
            road[k] = ok & (fwd | bwd)
    return road


def model_labeled(alpha, label, counts, w, reach_f, reach_b, bz, num_rings):
    """(labels, kf): road labels and each bin's smallest key (ring << 48 |
    bits(alpha) << 16 | slot) of a slot not road afterwards."""
    road = model_road(alpha, counts, w, reach_f, reach_b, bz)
    out = np.where(road & (label != 2), 1, label).astype(np.int32)
    kf = np.full(361, NO_KEY, np.int64)
    slot = np.arange(alpha.shape[1])
    for k in range(min(alpha.shape[0], int(num_rings))):
        a = alpha[k]
        with np.errstate(invalid="ignore"):
            take = ((slot < counts[k]) & (a >= 0) & (a <= F32(360.0))
                    & (out[k] != 1))
        bits = (a[take] + F32(0.0)).view(np.uint32).astype(np.int64)
        np.minimum.at(kf, np.floor(a[take]).astype(np.int64),
                      (k << 48) | (bits << 16) | slot[take])
    return out, kf


def _layout(alpha, label, counts):
    r, p = alpha.shape
    zf = torch.zeros((r, p), dtype=torch.float32)
    return RingLayout(x=zf, y=zf, z=zf, d2=zf,
                      alpha=torch.from_numpy(np.ascontiguousarray(alpha, F32)),
                      label=torch.from_numpy(label.astype(np.int32)),
                      pid=torch.full((r, p), -1, dtype=torch.int32),
                      counts=torch.from_numpy(counts.astype(np.int32)),
                      overflow=torch.zeros((), dtype=torch.int32))


def _assert_model(lay, reach_f, reach_b, w, bz, num_rings):
    """The model against flood_road_plain and flood_labeled_plain."""
    alpha, label = lay.alpha.numpy(), lay.label.numpy()
    counts = lay.counts.numpy()
    rf, rb, wn = reach_f.numpy(), reach_b.numpy(), w.numpy()
    road = bs.flood_road_plain(lay, reach_f, reach_b, w, bz).numpy()
    np.testing.assert_array_equal(road,
                                  model_road(alpha, counts, wn, rf, rb, bz))
    got, got_kf = bs.flood_labeled_plain(lay, reach_f, reach_b, w, bz,
                                         num_rings)
    want, want_kf = model_labeled(alpha, label, counts, wn, rf, rb, bz,
                                  int(num_rings))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_kf.numpy(), want_kf)
    return road


@pytest.fixture(scope="module")
def cases():
    """chip_smoke.py's flood_cases on a 16-ring x 300-slot layout."""
    rng = np.random.default_rng(0)
    base = _layout(rng.uniform(0, 360, (16, 300)).astype(F32),
                   np.zeros((16, 300), np.int32), np.full(16, 300))
    return _smoke().flood_cases(base, torch.tensor(12, dtype=torch.int32))


@pytest.mark.parametrize("k", range(13))
def test_model_on_flood_cases(cases, k):
    name, lay, rf, rb, w, bz, nr = cases[k]
    road = _assert_model(lay, rf, rb, w, bz, nr)
    if name.startswith(("all", "random")):
        assert road.any(), name
    if name.startswith("none"):
        assert not road.any()


@pytest.mark.parametrize("k", range(13))
def test_twin_equals_jax_eager_on_flood_cases(cases, k):
    """flood_road_plain against the JAX package's labeled_mask of both
    sweeps, eager, on the same inputs (compares only: exact)."""
    _, lay, rf, rb, w, bz, _ = cases[k]
    alpha = jnp.asarray(lay.alpha.numpy())
    slot_valid = (jnp.arange(alpha.shape[1])[None, :]
                  < jnp.asarray(lay.counts.numpy())[:, None])
    a_ok = (slot_valid & jnp.isfinite(alpha) & (alpha >= 0)
            & (alpha <= F32(360)))
    jw = jnp.asarray(w.numpy())
    want = np.asarray(
        jbs.labeled_mask(alpha, a_ok, jnp.asarray(rf.numpy()),
                         *jbs.sweep_bounds(jw, bz, +1)[1:])
        | jbs.labeled_mask(alpha, a_ok, jnp.asarray(rb.numpy()),
                           *jbs.sweep_bounds(jw, bz, -1)[1:]))
    np.testing.assert_array_equal(
        bs.flood_road_plain(lay, rf, rb, w, bz).numpy(), want)


def _edge_inputs(wk: float, bz: float, pattern: str, seed: int = 0):
    """Four rings (ring 0 and rings >= 1) of width wk: azimuths at every
    integer start, at fl(i +- wk) and one ulp either side, at -0.0, 360.0,
    NaN and just outside [0, 360]; ring 3 counts only half its slots.
    Reach bits per ``pattern``."""
    i = np.arange(STARTS, dtype=F32)
    with np.errstate(invalid="ignore", over="ignore"):
        ends = [i + F32(wk), i - F32(wk)]
    ends = [v for e in ends for v in (e, np.nextafter(e, F32(np.inf)),
                                      np.nextafter(e, F32(-np.inf)))]
    row = np.concatenate([i, np.nextafter(i, F32(np.inf)),
                          np.nextafter(i, F32(-np.inf)), *ends,
                          np.array([-0.0, 360.0, np.nan, -1e-3,
                                    np.nextafter(F32(360), F32(400)),
                                    np.nextafter(F32(0), F32(-1))], F32)])
    alpha = np.tile(row.astype(F32), (4, 1))
    p = alpha.shape[1]
    counts = np.array([p, p, p, p // 2])
    label = np.random.default_rng(seed).integers(0, 3, (4, p))
    rng = np.random.default_rng(seed + 1)
    at = np.arange(STARTS)
    rf = {"all": np.ones(STARTS, bool), "none": np.zeros(STARTS, bool),
          "alternating": at % 2 == 0,
          "special only": at == np.floor(F32(360.0) - F32(bz)),
          "only 361": at == 361,
          "random": rng.random(STARTS) < 0.2}[pattern]
    rb = {"alternating": at % 2 == 1, "special only": at == np.floor(bz),
          "random": rng.random(STARTS) < 0.2}.get(pattern, rf)
    reach = [torch.from_numpy(np.tile(v, (4, 1))) for v in (rf, rb)]
    w = torch.full((4,), wk, dtype=torch.float32)
    return _layout(alpha, label, counts), *reach, w


@pytest.mark.parametrize("pattern", ["all", "none", "alternating",
                                     "special only", "only 361", "random"])
@pytest.mark.parametrize("bz", [30.0, 45.5, 0.0])
@pytest.mark.parametrize("wk", WIDTHS)
def test_model_on_window_edges(wk, bz, pattern):
    lay, rf, rb, w = _edge_inputs(wk, bz, pattern)
    road = _assert_model(lay, rf, rb, w, bz, torch.tensor(3, dtype=torch.int32))
    if pattern == "none":
        assert not road.any()
    if pattern == "special only" and bz != 45.5 and not np.isnan(wk):
        # Rings >= 1 are road from the special starts alone; ring 0 only
        # where its own generic windows reach.
        assert road[1:].any()


@settings(max_examples=60, deadline=None, database=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1),
       wk=st.one_of(st.sampled_from(WIDTHS),
                    st.floats(-400.0, 400.0, width=32),
                    st.floats(width=32)),
       bz=st.one_of(st.sampled_from([30.0, 45.5, 0.0, 180.0, 359.0, 360.0,
                                     361.0, 12.25]),
                    st.floats(-1.0, 362.0, width=32)),
       density=st.sampled_from([0.0, 0.02, 0.3, 1.0]))
def test_model_sweep(seed, wk, bz, density):
    """Random rings around the window ends of random widths and beam zones:
    the model equals both twins."""
    rng = np.random.default_rng(seed)
    r, p = 3, 48
    w = np.array([wk, wk, rng.uniform(0, 50)], F32)
    start = rng.integers(0, STARTS, (r, p)).astype(F32)
    with np.errstate(invalid="ignore", over="ignore"):
        fwd, bwd = start + w[:, None], start - w[:, None]
    nudge = rng.integers(-1, 2, (r, p))
    pick = rng.integers(0, 4, (r, p))
    alpha = np.choose(pick, [start, fwd, bwd,
                             rng.uniform(-1, 361, (r, p)).astype(F32)])
    alpha = np.where(nudge > 0, np.nextafter(alpha, F32(np.inf)),
                     np.where(nudge < 0, np.nextafter(alpha, F32(-np.inf)),
                              alpha)).astype(F32)
    lay = _layout(alpha, rng.integers(0, 3, (r, p)),
                  rng.integers(0, p + 1, r))
    reach = [torch.from_numpy(rng.random((r, STARTS)) < density)
             for _ in range(2)]
    _assert_model(lay, *reach, torch.from_numpy(w), float(bz),
                  torch.tensor(int(rng.integers(0, 4)), dtype=torch.int32))


# --- The beam zone as a 0-d tensor (the device parameter buffer's form) ----

def _bz_forms(bz):
    """bz as a host float and as a 0-d view of a parameter buffer."""
    from urban_road_filter_torch.config import DYN_INDEX

    buf = torch.zeros(15, dtype=torch.float32)
    buf[DYN_INDEX["beam_zone"]] = float(F32(bz))
    return float(F32(bz)), buf[DYN_INDEX["beam_zone"]]


def _assert_bits(got, want):
    for g, w in zip(got, want):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("k", range(13))
def test_twins_take_beam_zone_as_tensor(cases, k):
    """Every flood twin and the glue give the same bits with the beam zone
    as a 0-d tensor as with the host float, on flood_cases."""
    name, lay, rf, rb, w, bz, nr = cases[k]
    f, t = _bz_forms(bz)
    _assert_bits(bs.flood_blocked_plain(lay, w, t),
                 bs.flood_blocked_plain(lay, w, f))
    _assert_bits(bs.flood_labeled_plain(lay, rf, rb, w, t, nr),
                 bs.flood_labeled_plain(lay, rf, rb, w, f, nr))
    _assert_bits((bs.flood_road_plain(lay, rf, rb, w, t),),
                 (bs.flood_road_plain(lay, rf, rb, w, f),))


@pytest.mark.parametrize("direction", [+1, -1])
@pytest.mark.parametrize("bz", [30.0, 45.5, 10.0, 100.0])
@pytest.mark.parametrize("ulp", [-1, 0, 1])
def test_window_glue_takes_beam_zone_as_tensor(bz, ulp, direction):
    """window_widths, sweep_bounds (edge = f32(360 - bz) in float64 on the
    tensor as on the host) and sweep_active at beam zones one ulp either
    side of integers and half-integers."""
    v = F32(bz)
    for _ in range(abs(ulp)):
        v = np.nextafter(v, F32(np.inf if ulp > 0 else -np.inf))
    f, t = _bz_forms(v)
    max_dist = torch.from_numpy(np.random.default_rng(3).uniform(
        0.5, 40.0, 16).astype(F32))
    wf, wt = bs.window_widths(max_dist, f), bs.window_widths(max_dist, t)
    _assert_bits((wt,), (wf,))
    assert wt[0] == t
    _assert_bits(bs.sweep_bounds(wt, t, direction),
                 bs.sweep_bounds(wf, f, direction))
    _assert_bits((bs.sweep_active(t, direction, "cpu"),),
                 (bs.sweep_bounds(wf, f, direction)[0],))
