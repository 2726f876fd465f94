"""Host I/O: host ms per scan in the compiled entry's ``urf::copy_in``
ranges of the traced segment, its input copied into the entry's buffer
(from pageable rows the copy blocks the host there)."""

from benchmark import program_trace


def read(ctx):
    return program_trace.span_ms(ctx, "urf::copy_in")
