"""The stages' glue: device ms per scan of every device kernel that is not
one of the port's own (benchmark/kernels.json), and of the memsets, in the
traced segment."""


def read(ctx):
    ms = ctx.device_ms_per_scan("glue", "memset")
    return ms if ms else None
