"""host_encode_cpu_ms_per_image (ms): the host encode workers'
thread-CPU time inside their per-image calls (the program's "encode"
spans), summed over the window's batches, over the images they
encoded."""

from portbench.spans import total, window_batches


def read(ctx):
    batches = window_batches(ctx)
    if batches is None:
        return None
    images = total(batches, "encode", "images")
    return total(batches, "encode", "worker_cpu_ns") / 1e6 / images \
        if images else None
