"""gif_device_ms_per_frame (ms): the device time of the traced window's
kernel, memcpy and memset records (the profiler's trace; the window is
made of transcode_gif_batch calls alone) over the output frames
completed."""


def read(ctx):
    if ctx.trace is None or not ctx.window.units:
        return None
    us = sum(d for _, _, d in ctx.trace.kernels + ctx.trace.copies)
    return us / 1e3 / ctx.window.units if us else None
