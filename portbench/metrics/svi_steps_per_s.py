"""ELBO steps completed over the window's seconds: every call's steps over
the calls' wall time, each call fenced."""

from portbench.harness import readers


def read(run):
    return readers.per_job_rate(run, "steps")
