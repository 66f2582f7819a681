"""Set-up: process start to the first timed call (imports, the CUDA
context, loading the built kernels, tables, input pools, warm-up)."""


def read(run):
    return run.setup_s
