"""Device operations in the trace per SVI step."""

from portbench.harness import readers


def read(run):
    return readers.launches_per(run, "steps")
