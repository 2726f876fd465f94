"""Compiled entry points: host ms per scan in the entry's ``urf::clone``
ranges of the traced segment, the graph's outputs cloned."""

from benchmark import program_trace


def read(ctx):
    return program_trace.span_ms(ctx, "urf::clone")
