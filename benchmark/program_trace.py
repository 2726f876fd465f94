"""What the program records of itself while a trace runs, for the
per-layer readers:

  * the replay record (``urban_road_filter_torch.utils.profiling``): the
    device ms of each stage inside the compiled entries' traced replays,
    and of each replay from its body's first timing event to its last;
  * the entries' host ranges in the traced segment: ``urf::entry.<kind>``
    around each call, inside it ``urf::copy_in``, ``urf::launch``,
    ``urf::clone`` and ``urf::stage_read``.

The SP run names its stages ``sp_<stage>``; they count as ``<stage>``,
and its partition and ring discovery (``sp_partition``, ``sp_rings``) as
the ingest, so that an SP cell and a single-scan cell compare stage by
stage.  A program that records neither (an older tree) gives None, never
an error, as does a run without a trace or with an empty one.
"""

from __future__ import annotations

from benchmark.devtrace import union_s

ENTRY = "urf::entry."
CHILDREN = ("urf::copy_in", "urf::launch", "urf::clone", "urf::stage_read")
SP_INGEST = ("sp_partition", "sp_rings")


def stage_of(name: str) -> str:
    """The stage a recorded stage name counts as."""
    if name in SP_INGEST:
        return "ingest"
    return name[3:] if name.startswith("sp_") else name


def _record():
    """The program's replay record, its pending replays read first, or
    None where the program keeps none."""
    try:
        from urban_road_filter_torch.utils import profiling
    except ImportError:
        return None
    flush = getattr(profiling, "flush", None)
    record = getattr(profiling, "replay_record", None)
    if flush is None or record is None:
        return None
    flush()
    return record()


def replay_totals(ctx):
    """({stage: device ms}, replay device ms, scans) summed over the
    record's entry kinds (a run traces one), or None with nothing
    timed."""
    if ctx.trace is None or not ctx.trace.device:
        return None
    record = _record()
    if not record:
        return None
    stages, replay, timed = {}, 0.0, 0
    for rec in record.values():
        timed += rec["timed"]
        replay += rec["replay_ms"]
        for name, ms in rec["stage_ms"].items():
            stage = stage_of(name)
            stages[stage] = stages.get(stage, 0.0) + ms
    if not timed:
        return None
    return stages, replay, timed * ctx.scans_per_call


def stage_ms(ctx, stage: str):
    """Device ms per timed scan of ``stage`` inside the traced replays."""
    totals = replay_totals(ctx)
    if totals is None or stage not in totals[0]:
        return None
    return totals[0][stage] / totals[2]


def replay_ms(ctx):
    """Device ms per timed scan from a replay's first event to its last."""
    totals = replay_totals(ctx)
    return None if totals is None else totals[1] / totals[2]


def _host(ctx):
    tr = ctx.trace
    if tr is None or not tr.scans or not tr.host:
        return None
    return tr


def span_ms(ctx, name: str):
    """Host ms per scan of the traced segment in the ranges ``name``."""
    tr = _host(ctx)
    if tr is None:
        return None
    us = [e - s for s, e, n in tr.host if n == name]
    return sum(us) / tr.scans / 1e3 if us else None


def entry_self_ms(ctx):
    """Host ms per scan in the ``urf::entry.<kind>`` ranges less the union
    of the child ranges inside each."""
    tr = _host(ctx)
    if tr is None:
        return None
    entries = [(s, e) for s, e, n in tr.host if n.startswith(ENTRY)]
    if not entries:
        return None
    children = sorted((s, e) for s, e, n in tr.host if n in CHILDREN)
    self_us = 0.0
    for s, e in entries:
        inside = [(max(a, s), min(b, e)) for a, b in children
                  if a < e and b > s]
        self_us += (e - s) - union_s(inside) * 1e6
    return self_us / tr.scans / 1e3
