"""host_decode_cpu_ms_per_image (ms): the decode workers' thread-CPU time
inside their per-image calls (the program's "decode" spans), summed over
the window's batches, over the images they decoded."""

from portbench.spans import total, window_batches


def read(ctx):
    batches = window_batches(ctx)
    if batches is None:
        return None
    images = total(batches, "decode", "images")
    return total(batches, "decode", "worker_cpu_ns") / 1e6 / images \
        if images else None
