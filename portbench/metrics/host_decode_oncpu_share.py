"""host_decode_oncpu_share (%): the decode workers' thread-CPU time over
their wall time inside the same per-image calls (the program's "decode"
spans), in the window's batches. The rest is time the kernel did not
count as the workers': blocked on a lock (the interpreter's) or on I/O,
or waiting for a core where the kernel sees that wait."""

from portbench.spans import total, window_batches


def read(ctx):
    batches = window_batches(ctx)
    if batches is None:
        return None
    wall = total(batches, "decode", "worker_wall_ns")
    return 100.0 * total(batches, "decode", "worker_cpu_ns") / wall \
        if wall else None
