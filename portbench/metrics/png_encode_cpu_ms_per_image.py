"""png_encode_cpu_ms_per_image (ms): the PNG encode workers' thread-CPU
time in the row filter and the deflate (counts png_filter_cpu_ns and
png_deflate_cpu_ns of the program's "encode" spans), summed over the
window's batches, over the images they encoded."""

from portbench.png_counts import cpu_ms_per_image


def read(ctx):
    return cpu_ms_per_image(ctx, "encode", ("png_filter_cpu_ns",
                                            "png_deflate_cpu_ns"))
