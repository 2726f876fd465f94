"""Beam-sorted star-walk streams for the port's K4 tests (numpy only, so
the GPU tests can use them without JAX)."""

import numpy as np

F32 = np.float32
I32 = np.int32


def walk_streams(seed, max_len=300):
    """Beam-sorted star streams with every corner of the walk: empty and
    one-point beams, coincident radii (inf and 0/0 NaN slopes), curb-like
    z steps, and a sink of dropped points at +inf radius."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, max_len, 360)
    lengths[:3] = [0, 1, 2]
    fk = np.repeat(np.arange(360), lengths)
    n = fk.size
    step = rng.exponential(0.05, n).astype(F32)
    step[rng.random(n) < 0.05] = 0.0  # coincident radii
    z = rng.normal(0.0, 0.02, n).astype(F32)
    z[rng.random(n) < 0.02] += F32(0.2)
    same = np.flatnonzero((step == 0) & (rng.random(n) < 0.5))
    z[same[same > 0]] = z[same[same > 0] - 1]  # 0/0: a NaN slope
    starts = np.repeat(np.cumsum(lengths) - lengths, lengths)
    total = np.cumsum(step, dtype=np.float64)
    r = (2.0 + total - total[starts]).astype(F32)
    sink = rng.integers(0, 40)
    fk = np.concatenate([fk, np.full(sink, 360)]).astype(I32)
    r = np.concatenate([r, np.full(sink, np.inf, F32)])
    z = np.concatenate([z, rng.normal(size=sink).astype(F32)])
    pid = rng.permutation(n + sink).astype(I32)
    return fk, r, z, pid


def scatter_streams(streams, seed=0):
    """Unsorted star inputs whose stable (beam, radius, input order) order
    is the order of the beam-sorted streams (fk, r, z, pid): the points are
    placed at random input indices, increasing along each run of equal
    (beam, radius), so ties keep their stream order.  Returns ((fk, r, z)
    in input order, pid): pid[s] is the input index of stream element s."""
    fk, r, z, _ = streams
    n = fk.size
    q = np.random.default_rng(seed).permutation(n)
    run = np.cumsum(np.r_[0, (fk[1:] != fk[:-1])
                          | (r[1:].view(I32) != r[:-1].view(I32))])
    pid = q[np.lexsort((q, run))].astype(I32)
    out = []
    for a in (fk, r, z):
        b = np.empty_like(a)
        b[pid] = a
        out.append(b)
    return tuple(out), pid
