"""For each NUTS job, the minimum over coordinates of the bulk
multi-chain ESS of its sampling draws (0 for a job whose maximum
split-R-hat is 1.01 or more); their sum over the jobs' wall seconds,
warm-up included."""

from portbench.harness import readers


def read(run):
    return readers.per_job_rate(run, "ess")
