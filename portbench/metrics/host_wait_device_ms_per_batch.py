"""host_wait_device_ms_per_batch (ms): the mean wall time of the
program's "wait_outputs" spans in the window's batches: how long the
front waited for a batch's outputs to reach the host before encoding
them."""

from portbench.spans import mean_ms, window_batches


def read(ctx):
    batches = window_batches(ctx)
    return None if batches is None else mean_ms(batches, "wait_outputs")
