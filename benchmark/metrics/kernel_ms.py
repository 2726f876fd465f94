"""The port's CUDA kernels: device ms per scan of the kernels named in
benchmark/kernels.json, in the traced segment."""


def read(ctx):
    ms = ctx.device_ms_per_scan("own")
    return ms if ms else None
