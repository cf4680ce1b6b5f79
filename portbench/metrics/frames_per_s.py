"""frames_per_s (frames/s): every output GIF frame completed in the
window over the window's host-clock seconds."""


def read(ctx):
    return ctx.window.units / ctx.window.seconds
