"""Stages: device ms per scan of the ``blind_spots`` stage inside the compiled
entries' traced replays, from its entry event to its exit event
(benchmark/program_trace.py)."""

from benchmark import program_trace


def read(ctx):
    return program_trace.stage_ms(ctx, "blind_spots")
