"""K7, the curb stencils, as csrc/xz_zero.cu decomposes them, on the CPU.

A numpy model of the kernel (``model``) repeats its work block by block:
a tile of TILE slots of one row that exits before any load where none of
its slots can hold a mark, its slots and a halo of cp slots each side
copied into "shared memory" by two coalesced loads a thread, x-zero in
gather form (thread m tests window m - cp/2), z-zero at m with
its sums over k = 1..cp in order, and LABEL_CURB written only by the
thread that owns a slot, only where it marks.  It asserts while it runs
that no slot at or past a row's count is read, that every value a window
reads was loaded and that no slot is written twice.  It is held bit for
bit against the plain twins (ops/xzero.x_zero, ops/zzero.z_zero), the
CPU forms of the wrappers (in place and returning) and the JAX package's
x_zero / z_zero run eagerly, at cp 1 to 30, on rings that are empty,
shorter than a window, full, and that end just past a tile edge, with NaN
z inside windows and star labels already on the table; a hypothesis sweep
varies all of it.

The azimuth-sharded entry (fused_xz_zero_halo: every wedge's ring
segment with the halo points the halo exchange gives it) is held, through
the same model and its plain twin xz_zero_halo_plain (the halo-extended
rows that the SP path built before the kernel took them over), against
the JAX package's _halo_exchange, _extend_with_halo, _x_zero_halo and
_z_zero_halo run eagerly under vmap over the wedge axis, and against the
single-scan stencils on the whole rings: with D = 1, 2 and 8 wedges, thin
and empty wedges, rings of fewer than 2cp + 1 points and wedge rows of
fewer slots than cp.  Tolerance: exact everywhere.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from urban_road_filter_tpu.config import FilterConfig as JaxConfig
from urban_road_filter_tpu.ops import geometry as jgeo
from urban_road_filter_tpu.ops.xzero import x_zero as jx_zero
from urban_road_filter_tpu.ops.zzero import z_zero as jz_zero
from urban_road_filter_tpu.parallel import azimuth_parallel as jap
from urban_road_filter_torch.config import FilterConfig
from urban_road_filter_torch.ops.geometry import RingLayout
from urban_road_filter_torch.ops.stencil_kernels import (
    fused_xz_zero, fused_xz_zero_, fused_xz_zero_halo, xz_zero_halo_plain,
    xz_zero_plain)
from urban_road_filter_torch.parallel.azimuth_parallel import (
    LocalWedges, _halo)

torch.set_num_threads(1)  # tier-1 runs several pytest workers

F32 = np.float32
I32 = np.int32
CU = (Path(__file__).resolve().parent.parent / "urban_road_filter_torch"
      / "csrc" / "xz_zero.cu").read_text()
TILE = int(re.search(r"constexpr int TILE = (\d+);", CU).group(1))
CP_MAX = int(re.search(r"constexpr int CP_MAX = (\d+);", CU).group(1))
TOGGLES = {"both": {}, "x_only": dict(z_zero_method=False),
           "z_only": dict(x_zero_method=False)}


def _new_y(k, length):
    return (np.clip(k, 0, length - 1).astype(np.float64) * 0.01).astype(F32)


def model(x, y, z, counts, label, cfg, tile=TILE, ladder_off=None,
          ladder_len=None, halo=None, stats=None):
    """The label csrc/xz_zero.cu leaves in ``label`` (a copy is returned),
    block by block.  ``halo``: dict of the (rows, cp)
    left/right blocks "lx", "ly", "lz", "rx", "ry", "rz", their counts
    "ln", "rn" (rows,), "prefix" (rows,), "total" (rings,), as
    urf_xz_zero_halo takes them (the ladder offset is then the prefix, its
    length ``ladder_len``).  ``stats`` (rows,) counts the tiles of each row
    that load."""
    cp = int(cfg.curb_points)
    h = cp // 2
    do_x, do_z = bool(cfg.x_zero_method), bool(cfg.z_zero_method)
    cos_x, cos_z = F32(cfg.cos_x), F32(cfg.cos_z)
    ch = F32(cfg.curb_height)
    rows, p = x.shape
    out = label.copy()
    writes = np.zeros(label.shape, np.int64)
    if halo is not None:
        ladder_off = halo["prefix"]
    if ladder_off is None:
        ladder_len = p
    assert 1 <= cp <= CP_MAX and tile + 2 * cp <= 2 * tile

    def tile_marks(b, t0, n, ln, rn):
        """One block: its slots from t0 and a cp halo each side staged in
        shared memory, then each thread's windows."""
        base = t0 - cp
        shared = {f: np.full(tile + 2 * cp, np.nan, F32) for f in "xyz"}
        loaded = np.zeros(tile + 2 * cp, bool)
        lo, hi = max(base, 0), min(t0 + tile + cp, n)
        # Thread t loads slots lo + t and lo + tile + t below hi.
        slots = [lo + t + k * tile for k in (0, 1) for t in range(tile)
                 if lo + t + k * tile < hi]
        assert sorted(slots) == list(range(lo, hi)) and hi <= n
        for f, a in zip("xyz", (x, y, z)):
            shared[f][lo - base:hi - base] = a[b, lo:hi]
        loaded[lo - base:hi - base] = True
        if halo is not None:
            left = np.arange(max(base, -ln), 0)
            right = np.arange(max(base, n), min(t0 + tile + cp, n + rn))
            assert len(left) <= cp and len(right) <= cp
            for f in "xyz":
                shared[f][left - base] = halo["l" + f][b, cp + left]
                shared[f][right - base] = halo["r" + f][b, right - n]
            loaded[left - base] = loaded[right - base] = True
        m = np.arange(t0, min(t0 + tile, n))
        pre = int(halo["prefix"][b]) if halo is not None else 0
        total = (int(halo["total"][b % len(halo["total"])])
                 if halo is not None else n)
        off = int(ladder_off[b]) if ladder_off is not None else 0

        def rd(f, s):
            assert loaded[s - base].all(), "a window read an unloaded slot"
            return shared[f][s - base]

        mark = np.zeros(m.shape, bool)
        with np.errstate(invalid="ignore", divide="ignore"):
            j = m - h
            gx = (do_x & (pre + j >= cp) & (pre + j <= total - 1 - cp)
                  & (j >= -ln) & (j + cp < n + rn))
            if gx.any():
                j = j[gx]
                ddx = rd("x", j + cp) - rd("x", j)
                ddy = rd("y", j + cp) - rd("y", j)
                d = np.sqrt(ddx * ddx + ddy * ddy)
                ny = [_new_y(j + k + off, ladder_len) for k in (0, h, cp)]
                dny1, dny2, dny3 = ny[1] - ny[0], ny[2] - ny[1], ny[2] - ny[0]
                zj, zh, zc = rd("z", j), rd("z", j + h), rd("z", j + cp)
                a1, a2, a3 = zh - zj, zc - zh, zc - zj
                x1 = np.sqrt(dny1 * dny1 + a1 * a1)
                x2 = np.sqrt(dny2 * dny2 + a2 * a2)
                x3 = np.sqrt(dny3 * dny3 + a3 * a3)
                bracket = (x3 * x3 - x1 * x1 - x2 * x2) / (F32(-2) * x1 * x2)
                mark[gx] = ((d < F32(5)) & (bracket >= cos_x)
                            & ((np.abs(zj - zh) >= ch)
                               | (np.abs(zc - zh) >= ch))
                            & (np.abs(zj - zc) >= F32(0.05)))
            gz = (do_z & (pre + m >= cp) & (pre + m <= total - 1 - cp)
                  & (m - cp >= -ln) & (m + cp < n + rn))
            if gz.any():
                mm = m[gz]
                ddx = rd("x", mm + cp) - rd("x", mm - cp)
                ddy = rd("y", mm + cp) - rd("y", mm - cp)
                d = np.sqrt(ddx * ddx + ddy * ddy)
                xm, ym = rd("x", mm), rd("y", mm)
                absz = np.abs(rd("z", mm))
                va1 = np.zeros(mm.shape, F32)
                va2, vb1, vb2 = va1.copy(), va1.copy(), va1.copy()
                max1, max2 = absz, absz
                for k in range(1, cp + 1):
                    va1 = va1 + (rd("x", mm - k) - xm)
                    va2 = va2 + (rd("y", mm - k) - ym)
                    vb1 = vb1 + (rd("x", mm + k) - xm)
                    vb2 = vb2 + (rd("y", mm + k) - ym)
                    max1 = np.maximum(max1, np.abs(rd("z", mm - k)))
                    max2 = np.maximum(max2, np.abs(rd("z", mm + k)))
                inv = F32(1) / F32(cp)
                va1, va2, vb1, vb2 = va1 * inv, va2 * inv, vb1 * inv, vb2 * inv
                bracket = (va1 * vb1 + va2 * vb2) / (
                    np.sqrt(va1 * va1 + va2 * va2)
                    * np.sqrt(vb1 * vb1 + vb2 * vb2))
                mark[gz] |= ((d < F32(5)) & (bracket >= cos_z)
                             & ((max1 - absz >= ch) | (max2 - absz >= ch))
                             & (np.abs(max1 - max2) >= F32(0.05)))
        out[b, m[mark]] = 2  # LABEL_CURB, by the slot's own thread
        writes[b, m[mark]] += 1

    for b in range(rows):
        n = min(int(counts[b]), p)
        ln = int(halo["ln"][b]) if halo is not None else 0
        rn = int(halo["rn"][b]) if halo is not None else 0
        for t0 in range(0, p, tile):
            if t0 >= n or t0 > n + rn - 1 - cp + h:
                continue  # no slot can hold a mark: the block exits
            if stats is not None:
                stats[b] += 1
            tile_marks(b, t0, n, ln, rn)
    assert writes.max(initial=0) <= 1
    return out


def _ring(rng, n, radius, nan_at=()):
    """n points of a ring with curb-like z steps, as a sensor sweeps it."""
    t = np.arange(n) * 0.045 / radius + rng.uniform(0, 6)
    rad = np.full(n, radius)
    z = -1.6 + rng.normal(0, 0.006, n)
    for at in rng.integers(0, max(n, 1), max(n // 40, 1)):
        end = at + rng.integers(3, 40)  # a curb: up and out, then back
        z[at:end] += rng.uniform(0.06, 0.25)
        rad[at:end] += rng.uniform(-0.4, 0.4)
    x = rad * np.cos(t) + rng.normal(0, 0.004, n)
    y = rad * np.sin(t) + rng.normal(0, 0.004, n)
    z[np.asarray(nan_at, int)] = np.nan
    return x.astype(F32), y.astype(F32), z.astype(F32)


def _layout(rng, counts, p, nan_rows=(), star=0.05):
    """A (len(counts), p) layout: rings of those lengths, garbage past each
    count (never to be read), star labels on a share of the slots."""
    r = len(counts)
    xyz = [rng.normal(0, 1e3, (r, p)).astype(F32) for _ in range(3)]
    for i, n in enumerate(counts):
        nan_at = rng.integers(0, n, 3) if (i in nan_rows and n) else ()
        for a, v in zip(xyz, _ring(rng, n, 3.0 + 0.7 * i, nan_at)):
            a[i, :n] = v
    label = np.where(rng.random((r, p)) < star, 2, 0).astype(I32)
    return (*xyz, np.asarray(counts, I32), label)


def _torch_layout(x, y, z, counts, label):
    t = [torch.from_numpy(np.array(a)) for a in (x, y, z)]
    return RingLayout(x=t[0], y=t[1], z=t[2], d2=t[0], alpha=t[0],
                      label=torch.from_numpy(label.copy()),
                      pid=torch.zeros(label.shape, dtype=torch.int32),
                      counts=torch.from_numpy(np.array(counts)),
                      overflow=torch.zeros((), dtype=torch.int32))


def _jax_stencils(x, y, z, counts, label, cfg):
    lay = jgeo.RingLayout(*map(jnp.asarray, (x, y, z, x, x, label, label,
                                             counts)), jnp.int32(0))
    if cfg.x_zero_method:
        lay = jx_zero(lay, cfg)
    if cfg.z_zero_method:
        lay = jz_zero(lay, cfg)
    return np.asarray(lay.label)


def _cfgs(cp, toggle):
    kw = dict(curb_points=cp, **TOGGLES[toggle])
    return JaxConfig(**kw), FilterConfig(**kw)


@pytest.mark.parametrize("toggle", list(TOGGLES))
@pytest.mark.parametrize("cp", [1, 2, 3, 5, 10, 30])
def test_model_matches_twins_and_jax(cp, toggle):
    """Rings of 0 points, 2cp points (under one window), p points, one
    past a tile edge, one short of it and one past two small tiles; NaN z
    inside windows; star labels on the table."""
    jcfg, cfg = _cfgs(cp, toggle)
    rng = np.random.default_rng(cp)
    p = 2 * TILE + 40
    counts = [0, 2 * cp, p, TILE + 1, TILE - 1, 33, TILE // 2 + 1, p - 1]
    x, y, z, c, label = _layout(rng, counts, p, nan_rows=(2, 6))
    stats = np.zeros(len(counts), int)
    got = model(x, y, z, c, label, cfg, stats=stats)
    # The tiles that load: none at n = 0, every one up to the last that
    # can hold a mark (x-zero's last mark is n - 1 - cp + cp/2: at n = TILE
    # + 1 the second tile holds a point but no mark, and exits).
    last = np.array(counts) - 1 - cp + cp // 2
    want = np.where(np.array(counts) > 0, last // TILE + 1, 0)
    np.testing.assert_array_equal(stats, want)
    assert list(want[:4]) == [0, 1, 3, 1]
    np.testing.assert_array_equal(model(x, y, z, c, label, cfg, tile=61),
                                  got)
    np.testing.assert_array_equal(_jax_stencils(x, y, z, c, label, jcfg), got)
    lay = _torch_layout(x, y, z, c, label)
    np.testing.assert_array_equal(xz_zero_plain(lay, cfg).label.numpy(), got)
    new = fused_xz_zero(lay, cfg)
    np.testing.assert_array_equal(new.label.numpy(), got)
    np.testing.assert_array_equal(lay.label.numpy(), label)  # not mutated
    fused_xz_zero_(lay, cfg)
    np.testing.assert_array_equal(lay.label.numpy(), got)
    fused_xz_zero_(lay, cfg)  # idempotent: the marks ignore the label
    np.testing.assert_array_equal(lay.label.numpy(), got)
    np.testing.assert_array_equal(model(x, y, z, c, got, cfg), got)
    fresh = (got == 2) & (label != 2)
    # x-zero with cp = 1 never marks: its first two window points coincide
    # (x1 = 0, a NaN bracket), in the reference too.
    assert fresh[2:5].any() or (cp == 1 and toggle == "x_only")
    assert not fresh[0].any() and not fresh[1].any()
    assert ((got == 2) >= (label == 2)).all()


def test_model_ladder_offset():
    """The per-ring newY ladder offset, clipped at both ends, against the
    twin's new_y_ladder and the CPU form of the wrapper."""
    _, cfg = _cfgs(5, "x_only")
    cfg = cfg.replace(curb_height=0.05)
    rng = np.random.default_rng(4)
    p = 300
    x, y, z, c, label = _layout(rng, [300, 260, 290, 120], p, star=0.0)
    off = np.array([-20, 0, 2350, 1000], I32)
    want = model(x, y, z, c, label, cfg, ladder_off=off, ladder_len=2400)
    assert (want == 2).any()
    lay = _torch_layout(x, y, z, c, label)
    got = fused_xz_zero(lay, cfg, ladder_offset=torch.from_numpy(off),
                        ladder_len=2400)
    np.testing.assert_array_equal(got.label.numpy(), want)


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), cp=st.sampled_from([1, 2, 3, 5, 7,
                                                           30]),
       tile=st.integers(2 * CP_MAX, 300),
       toggle=st.sampled_from(list(TOGGLES)))
def test_model_hypothesis(seed, cp, tile, toggle):
    _, cfg = _cfgs(cp, toggle)
    rng = np.random.default_rng(seed)
    p = int(rng.integers(2 * cp + 1, 2 * cp + 200))
    counts = rng.integers(0, p + 1, int(rng.integers(1, 5)))
    x, y, z, c, label = _layout(rng, counts, p,
                                nan_rows=range(0, len(counts), 2),
                                star=rng.uniform(0, 0.3))
    got = model(x, y, z, c, label, cfg, tile=tile)
    np.testing.assert_array_equal(model(x, y, z, c, label, cfg), got)
    lay = _torch_layout(x, y, z, c, label)
    np.testing.assert_array_equal(xz_zero_plain(lay, cfg).label.numpy(), got)


def _split_rings(rng, totals, d, cap_slack=3, thin=True):
    """Each ring's points cut into d consecutive wedge segments (some
    empty, some thinner than a window when ``thin``): the global rings and
    the stacked (d * rings, cap) layout of their segments."""
    r = len(totals)
    cuts = []
    for n in totals:
        if thin:
            c = np.sort(rng.integers(0, n + 1, d - 1))
        else:
            c = np.round(np.linspace(0, n, d + 1)[1:-1]).astype(int)
        cuts.append(np.diff(np.concatenate([[0], c, [n]])).astype(int))
    cuts = np.array(cuts).reshape(r, d)
    cap = int(cuts.max()) + cap_slack
    p_glob = cap * d
    gx, gy, gz, gc, glabel = _layout(rng, totals, p_glob, nan_rows=(1,))
    xyz = [rng.normal(0, 1e3, (d * r, cap)).astype(F32) for _ in range(3)]
    label = np.zeros((d * r, cap), I32)
    counts = np.zeros(d * r, I32)
    for i in range(r):
        start = 0
        for w in range(d):
            k = cuts[i, w]
            row = w * r + i
            for a, g in zip(xyz, (gx, gy, gz)):
                a[row, :k] = g[i, start:start + k]
            label[row, :k] = glabel[i, start:start + k]
            counts[row] = k
            start += k
    return (gx, gy, gz, gc, glabel), (*xyz, counts, label), cuts


def _halo_inputs(stacked, d, rings, cp):
    lay = _torch_layout(*stacked)
    left, right = _halo(LocalWedges(d), lay, rings, cp)
    counts_g = lay.counts.view(d, rings)
    prefix = torch.cumsum(counts_g, 0, dtype=torch.int32) - counts_g
    total = counts_g.sum(0, dtype=torch.int32)
    return lay, left, right, prefix, total


def _model_halo(stacked, left, right, prefix, total, cfg, d, rings):
    cp = left["x"].shape[-1]
    halo = {"prefix": prefix.reshape(-1).numpy(), "total": total.numpy()}
    for key, side in (("l", left), ("r", right)):
        for f in "xyz":
            halo[key + f] = side[f].reshape(d * rings, cp).numpy()
        halo[key + "n"] = side["n"].reshape(-1).numpy()
    cap = stacked[0].shape[1]
    return model(*stacked, cfg, halo=halo, ladder_len=cap * d)


def _jax_halo(stacked, d, rings, cfg):
    """The JAX SP path's stencil block (azimuth_parallel.py:286-306), its
    collectives those of vmap over the wedge axis, run eagerly."""
    cp = int(cfg.curb_points)
    x, y, z, counts, label = (np.asarray(a).reshape(d, rings, *a.shape[1:])
                              for a in stacked)

    def wedge(x, y, z, counts, label):
        lay = jgeo.RingLayout(x, y, z, x, x, label, label, counts,
                              jnp.int32(0))
        left, right = jap._halo_exchange(lay, cp)
        ext = jap._extend_with_halo(lay, left, right, cp)
        counts_g = jax.lax.all_gather(counts, jap.AX)
        me = jax.lax.axis_index(jap.AX)
        prefix = jnp.sum(jnp.where(jnp.arange(d)[:, None] < me, counts_g, 0),
                         axis=0)
        ext_layout = lay._replace(x=ext["x"], y=ext["y"], z=ext["z"],
                                  label=jnp.pad(label, ((0, 0),
                                                        (2 * cp, cp))))
        frame = jap._StencilFrame(prefix=prefix, total=jnp.sum(counts_g, 0),
                                  lhalo_n=jnp.minimum(left["n"], cp),
                                  rhalo_n=jnp.minimum(right["n"], cp), cp=cp)
        if cfg.x_zero_method:
            ext_layout = jap._x_zero_halo(ext_layout, cfg, frame)
        if cfg.z_zero_method:
            ext_layout = jap._z_zero_halo(ext_layout, cfg, frame)
        return ext_layout.label[:, 2 * cp:-cp]

    with jax.disable_jit():
        out = jax.vmap(wedge, axis_name=jap.AX)(x, y, z, counts, label)
    return np.asarray(out).reshape(d * rings, -1)


@pytest.mark.parametrize("toggle", ["both", "x_only", "z_only"])
@pytest.mark.parametrize("d,cp,thin", [(1, 5, False), (2, 3, True),
                                       (8, 5, True), (8, 10, False),
                                       (8, 1, True), (2, 30, True)])
def test_halo_entry(d, cp, thin, toggle):
    """The SP entry on wedge segments of whole rings (rings of 0, 2cp and
    2cp + 1 points among them): the model, the plain twin and the CPU form
    of the wrapper agree, with the JAX halo stencils, and with the
    single-scan stencils on the whole rings (SP marks are the single
    scan's, bit for bit)."""
    jcfg, cfg = _cfgs(cp, toggle)
    rng = np.random.default_rng(100 * d + cp)
    totals = [0, 2 * cp, 2 * cp + 1, 40, 150, 400, 260, 90]
    glob, stacked, cuts = _split_rings(rng, totals, d, thin=thin)
    rings = len(totals)
    if thin and d > 2 and cp > 1:
        assert ((cuts > 0) & (cuts < cp)).any() and (cuts == 0).any()
    lay, left, right, prefix, total = _halo_inputs(stacked, d, rings, cp)
    got = _model_halo(stacked, left, right, prefix, total, cfg, d, rings)
    np.testing.assert_array_equal(
        xz_zero_halo_plain(lay, left, right, prefix, total, cfg).numpy(), got)
    fused_xz_zero_halo(lay, left, right, prefix, total, cfg)
    np.testing.assert_array_equal(lay.label.numpy(), got)
    np.testing.assert_array_equal(_jax_halo(stacked, d, rings, jcfg), got)
    # Back on the whole rings: the single-scan stencils' labels.
    single = xz_zero_plain(_torch_layout(*glob), cfg).label.numpy()
    for i in range(rings):
        start = 0
        for w in range(d):
            k = cuts[i, w]
            np.testing.assert_array_equal(got[w * rings + i, :k],
                                          single[i, start:start + k])
            start += k
    assert ((got == 2) & (stacked[4] != 2)).any() or (
        cp == 1 and toggle == "x_only")


def test_halo_entry_rows_shorter_than_cp():
    """Wedge rows of fewer slots than cp (a ring capacity under
    curb_points): the halo exchange pads its head blocks, and the SP marks
    are still the single scan's."""
    _, cfg = _cfgs(30, "both")
    rng = np.random.default_rng(5)
    totals = [61, 90, 140, 0, 125]
    glob, stacked, cuts = _split_rings(rng, totals, 8, cap_slack=0,
                                       thin=False)
    rings = len(totals)
    assert stacked[0].shape[1] < 30
    lay, left, right, prefix, total = _halo_inputs(stacked, 8, rings, 30)
    got = _model_halo(stacked, left, right, prefix, total, cfg, 8, rings)
    np.testing.assert_array_equal(
        xz_zero_halo_plain(lay, left, right, prefix, total, cfg).numpy(), got)
    fused_xz_zero_halo(lay, left, right, prefix, total, cfg)
    np.testing.assert_array_equal(lay.label.numpy(), got)
    single = xz_zero_plain(_torch_layout(*glob), cfg).label.numpy()
    for i in range(rings):
        start = 0
        for w in range(8):
            k = cuts[i, w]
            np.testing.assert_array_equal(got[w * rings + i, :k],
                                          single[i, start:start + k])
            start += k


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), d=st.sampled_from([1, 2, 3, 8]),
       cp=st.sampled_from([1, 2, 5, 9]))
def test_halo_entry_hypothesis(seed, d, cp):
    _, cfg = _cfgs(cp, "both")
    rng = np.random.default_rng(seed)
    totals = list(rng.integers(0, 6 * cp + 30, int(rng.integers(1, 5))))
    _, stacked, _ = _split_rings(rng, totals, d,
                                 cap_slack=int(rng.integers(0, 4)))
    lay, left, right, prefix, total = _halo_inputs(stacked, d, len(totals),
                                                   cp)
    got = _model_halo(stacked, left, right, prefix, total, cfg, d,
                      len(totals))
    np.testing.assert_array_equal(
        xz_zero_halo_plain(lay, left, right, prefix, total, cfg).numpy(), got)
