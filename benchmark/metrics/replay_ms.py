"""Compiled entry points: device ms per scan of a traced replay, from the
timing event before the body's first node to the one after its last, the
graph's own gaps between nodes included (benchmark/program_trace.py)."""

from benchmark import program_trace


def read(ctx):
    return program_trace.replay_ms(ctx)
