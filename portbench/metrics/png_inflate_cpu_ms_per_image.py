"""png_inflate_cpu_ms_per_image (ms): the PNG decode workers' thread-CPU
time in the inflate stage (count png_inflate_cpu_ns of the program's
"decode" spans), summed over the window's batches, over the images they
decoded."""

from portbench.png_counts import cpu_ms_per_image


def read(ctx):
    return cpu_ms_per_image(ctx, "decode", ("png_inflate_cpu_ns",))
