"""host_decode_pool_fill (%): the decode workers' wall time inside their
per-image calls over the "decode" span's wall time times the workers,
summed over the window's batches: how full the decode's thread pool
was (start-up, the batch's tail and the ICC walk leave it empty)."""

from portbench.spans import total, window_batches


def read(ctx):
    batches = window_batches(ctx)
    if batches is None:
        return None
    room = sum((b["decode"].end_ns - b["decode"].start_ns)
               * b["decode"].counts.get("workers", 0)
               for b in batches)
    return 100.0 * total(batches, "decode", "worker_wall_ns") / room \
        if room else None
