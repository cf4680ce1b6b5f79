"""h2d_ms_per_batch (ms): the device time of the window's host-to-device
copy records (the profiler's trace) over the batches of the window."""


def read(ctx):
    if ctx.trace is None or not ctx.window.calls:
        return None
    us = sum(d for name, _, d in ctx.trace.copies if "HtoD" in name)
    return us / 1e3 / ctx.window.calls if us else None
