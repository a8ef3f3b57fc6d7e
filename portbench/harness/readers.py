"""Arithmetic that several metric readers share.  A reader returns None
where its run has nothing to read (no trace, no kernel of its name, no
peak), and the metric is then left out of the result line."""

from __future__ import annotations


def total(run, key):
    return sum(r.get(key, 0) for r in run.records)


def per_job_rate(run, key):
    """Work ``key`` of the jobs that did not fail over all the jobs' wall
    seconds (a failed job's time was spent, its work was not done)."""
    return sum(r.get(key, 0) for r in run.records
               if not r["failed"]) / run.window_s


def idle_percent(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def launches_per(run, key):
    """Device operations in the trace, less those the benchmark itself
    added (``bench_ops``: copies that keep what the check reads), per unit
    of ``key``."""
    if run.trace is None or not total(run, key):
        return None
    return (len(run.trace.device_ops) - total(run, "bench_ops")) \
        / total(run, key)


def kernel_share(run, bound_s, kernels):
    """100 x the least time the work needs over the device time of
    ``kernels`` in the trace."""
    if run.trace is None:
        return None
    spent = run.trace.seconds(kernels)
    if spent <= 0 or bound_s is None:
        return None
    return 100.0 * bound_s / spent


def bound_seconds(run, flops=0.0, nbytes=0.0):
    """The larger of the operations at the TF32 peak and the bytes at the
    HBM peak."""
    if not run.peaks:
        return None
    return max(flops / run.peaks["tf32_flops"], nbytes / run.peaks["bytes"])
