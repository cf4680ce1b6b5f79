"""device_kernel_ms_per_batch (ms): the device time of the window's
kernel records (the profiler's trace) over the batches of the window."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels or not ctx.window.calls:
        return None
    return sum(d for _, _, d in ctx.trace.kernels) / 1e3 / ctx.window.calls
