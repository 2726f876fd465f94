"""Host I/O: device ms per scan of the memcpy rows (host to device,
device to host, device to device) in the traced segment."""


def read(ctx):
    ms = ctx.device_ms_per_scan("memcpy")
    return ms if ms else None
