"""host_dispatch_ms_per_batch (ms): the mean wall time of the program's
"dispatch" spans in the window's batches: the host's enqueue of a
batch's uploads, device step and output copies."""

from portbench.spans import mean_ms, window_batches


def read(ctx):
    batches = window_batches(ctx)
    return None if batches is None else mean_ms(batches, "dispatch")
