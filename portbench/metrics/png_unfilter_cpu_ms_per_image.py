"""png_unfilter_cpu_ms_per_image (ms): the PNG decode workers' thread-CPU
time in the unfilter stage (count png_unfilter_cpu_ns of the program's
"decode" spans), summed over the window's batches, over the images they
decoded."""

from portbench.png_counts import cpu_ms_per_image


def read(ctx):
    return cpu_ms_per_image(ctx, "decode", ("png_unfilter_cpu_ns",))
