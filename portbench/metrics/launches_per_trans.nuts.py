"""Device operations in the trace per NUTS transition (warm-up and
sampling)."""

from portbench.harness import readers


def read(run):
    return readers.launches_per(run, "transitions")
