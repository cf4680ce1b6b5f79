"""device_idle_share.jpeg (%): the share of the traced window in which no
kernel, memcpy or memset record of the profiler's trace ran on the card."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
