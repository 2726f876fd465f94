"""Compiled entry points: host ms per scan from the entry's call until it
returns, before any synchronisation, the mean over every call of the
measured window.  The entry takes host rows: where they are pageable (the
scan drivers) its copy-in blocks the host inside the call and counts
here; from pinned rows (the batch driver) the copy-in is only enqueued,
and what counts is the entry's own host work: the parameter buffer, the
enqueues, the graph's launch and the outputs' clones."""


def read(ctx):
    if not ctx.enqueue_s:
        return None
    return sum(ctx.enqueue_s) / len(ctx.enqueue_s) / ctx.scans_per_call * 1e3
