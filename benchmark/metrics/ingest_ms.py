"""Stages: device ms per scan of the ``ingest`` stage inside the compiled
entries' traced replays, from its entry event to its exit event; in the
SP run its partition and ring discovery (benchmark/program_trace.py)."""

from benchmark import program_trace


def read(ctx):
    return program_trace.stage_ms(ctx, "ingest")
