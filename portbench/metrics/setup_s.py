"""From the process's start to the window's start: imports, the CUDA
context, the kernel library (built on the first run of a checkout),
inputs, and the warm-up of the cell's own shapes."""


def read(run):
    return run.setup_s
