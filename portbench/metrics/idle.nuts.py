"""The device's idle share of the traced window: 1 - (union of kernel,
copy and set intervals) / window, in %."""

from portbench.harness import readers


def read(run):
    return readers.idle_percent(run)
