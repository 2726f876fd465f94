"""Compiled entry points: host ms per scan in the ``urf::entry.<kind>``
ranges of the traced segment outside their child ranges (copy-in,
launch, clones, the reading of the replay's events): the cache lookup and
key, the parameter buffer, the checks and bookkeeping."""

from benchmark import program_trace


def read(ctx):
    return program_trace.entry_self_ms(ctx)
