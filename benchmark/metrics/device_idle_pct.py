"""The device: share of the traced segment's host window in which no
kernel, memcpy or memset runs (the union of the device rows)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - tr.busy_s() / tr.window_s)
