"""Arithmetic on the program's own spans in a traced run.

While a profiler records, the port marks its layer boundaries with host
spans named ``bayesic.<module path>.<what>`` (``utils.metrics.named_scope``
in ``bayesic_tpu_torch``).  They are host ops of the ``Trace``, on the
device's clock, and nest by containment.  A program that records no such
span gives empty lists here, and its readers return None."""

from __future__ import annotations

import bisect
import re

from .trace import union_seconds

# a CUDA API call on the host (cudaLaunchKernel, cudaStreamSynchronize,
# cuLaunchKernel): host time spent handing work to the card or waiting
# for it, not the caller's own work
RUNTIME = re.compile(r"cu(da)?[A-Z]")


def named(trace, name):
    """The host spans called ``name``, ``(start_ns, end_ns, name)``, in
    order of start; none without a trace."""
    if trace is None:
        return []
    return [h for h in trace.host_ops if h[2] == name]


def runtime_calls(trace):
    return [h for h in trace.host_ops if RUNTIME.match(h[2])]


def inside(outer, items):
    """The ``items`` that lie within ``outer``'s interval."""
    return [h for h in items if h[0] >= outer[0] and h[1] <= outer[1]]


def length_s(span):
    return (span[1] - span[0]) * 1e-9


def covered_s(items):
    """Seconds that the union of the ``items``' intervals covers."""
    return union_seconds((h[0], h[1]) for h in items)


def self_s(span, children):
    """The span's seconds less what its ``children`` (spans within it)
    cover."""
    return length_s(span) - covered_s(inside(span, children))


def device_idle_after(trace, starts, ends):
    """For each ``starts[i]``: the device ops that start after it and
    before ``ends[i]`` (None: the trace's end), and the idle seconds
    between the first one's start and the latest end among them."""
    ops = trace.device_ops
    op_starts = [op[0] for op in ops]
    out = []
    for lo, hi in zip(starts, ends):
        a = bisect.bisect_left(op_starts, lo)
        b = len(ops) if hi is None else bisect.bisect_left(op_starts, hi)
        if a >= b:
            out.append(0.0)
            continue
        mine = ops[a:b]
        span = (mine[0][0], max(op[1] for op in mine))
        out.append(length_s(span) - covered_s(mine))
    return out
