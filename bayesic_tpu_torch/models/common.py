"""Shared example-model harness utilities.

Counterpart of ``bayesic_tpu/models/common.py``.  PyTorch returns before a
CUDA device finishes, so ``timed_steps`` fences each run with
``torch.cuda.synchronize()`` once the process has used CUDA.
"""

from __future__ import annotations

import json
import time

import torch

__all__ = ["timed_steps", "bench_line"]


def _force():
    """Wait for the CUDA work this process enqueued, if it used CUDA."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed_steps(run_fn, *args, warmup_runs=1, timed_runs=1, **kwargs):
    """Time ``run_fn``: returns (last_result, seconds per run), warm-up runs
    excluded, each run fenced (see _force)."""
    result = None
    for _ in range(warmup_runs):
        result = run_fn(*args, **kwargs)
        _force()
    t0 = time.perf_counter()
    for _ in range(timed_runs):
        result = run_fn(*args, **kwargs)
        _force()
    dt = (time.perf_counter() - t0) / timed_runs
    return result, dt


def bench_line(metric, value, unit, vs_baseline=None, **extra):
    """The one-JSON-line contract for a bench driver."""
    rec = {"metric": metric, "value": float(value), "unit": unit,
           "vs_baseline": vs_baseline if vs_baseline is not None else 1.0}
    rec.update(extra)
    line = json.dumps(rec)
    print(line)
    return rec
