"""Stages: device ms per scan of the ``xz_zero`` stage inside the compiled
entries' traced replays, from its entry event to its exit event
(benchmark/program_trace.py)."""

from benchmark import program_trace


def read(ctx):
    return program_trace.stage_ms(ctx, "xz_zero")
