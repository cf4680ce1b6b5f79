"""setup_s (s): from the process's start to the end of the warm-up, on
the host clock: imports, the program's kernels, the inputs, the pipeline
and the cell's shapes once."""


def read(ctx):
    return ctx.setup_s
