"""The port's kernels against their roofline: the least time the card
could take for one scan's kernels (the least bytes they move, from the
reference's counts, benchmark/bounds.py, over the HBM rate), as a share
of their device time per scan.  Nothing to read without kernel time."""


def read(ctx):
    ms = ctx.device_ms_per_scan("own")
    if not ms or ctx.bytes_per_scan is None:
        return None
    least_ms = ctx.bytes_per_scan / ctx.hbm_bytes_s * 1e3
    return 100.0 * least_ms / ms
