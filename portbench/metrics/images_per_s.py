"""images_per_s (images/s): every output image completed in the window
over the window's host-clock seconds (the window ends when the last
call returns)."""


def read(ctx):
    return ctx.window.units / ctx.window.seconds
