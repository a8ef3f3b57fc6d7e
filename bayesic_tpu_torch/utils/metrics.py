"""Structured metrics: a JSONL logger, profiler spans and traces.

Counterpart of ``bayesic_tpu/utils/metrics.py``.  The hot loop calls no
logger: the training loop reads its metrics every ``log_every`` steps,
and this module only formats and emits them, on rank 0 of a
``torch.distributed`` world (or the one process).

``named_scope`` marks a span of host work, named ``bayesic.<module
path>.<what>`` at the port's layer boundaries.  While a ``torch.profiler``
records (``profile_trace``, or any ``torch.profiler.profile``) the span is
a ``record_function``: it lands on the trace's clock, beside the device's
work, nested by containment on its thread.  While none records it is one
shared no-op context manager, a fraction of a microsecond: no span is
created, and nothing selects tracing but the profiler itself.
"""

from __future__ import annotations

import contextlib
import json
import time

import torch

__all__ = ["MetricsLogger", "named_scope", "profile_trace"]

_NO_SPAN = contextlib.nullcontext()


def named_scope(name):
    """A span named ``name`` on the recording ``torch.profiler`` trace
    (``jax.named_scope``'s role), or a shared no-op when none records."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


def _rank0():
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


class MetricsLogger:
    """JSONL emitter (rank 0 only in a multi-rank run), with an optional
    TensorBoard scalar writer (``tensorboard_dir=``; JSONL alone when no
    writer backend imports)."""

    def __init__(self, path=None, stream=None, enabled=None,
                 tensorboard_dir=None):
        if enabled is None:
            enabled = _rank0()
        self.enabled = enabled
        self._file = open(path, "a") if (path and enabled) else None
        self._stream = stream
        self._tb = None
        if tensorboard_dir and enabled:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(tensorboard_dir)
            except Exception:  # noqa: BLE001 — optional dependency
                self._tb = None
        self._t0 = time.time()

    def log(self, step, **scalars):
        if not self.enabled:
            return
        rec = {"step": int(step), "t": round(time.time() - self._t0, 3)}
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        line = json.dumps(rec)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()
        if self._stream:
            print(line, file=self._stream)
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ("step", "t") and isinstance(v, float):
                    self._tb.add_scalar(k, v, int(step))

    def close(self):
        if self._file:
            self._file.close()
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()


@contextlib.contextmanager
def profile_trace(logdir):
    """Context manager: a ``torch.profiler`` trace of the host and, when a
    card is present, its kernels, written into ``logdir`` as a Chrome /
    Perfetto trace."""
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(str(logdir))):
        yield
