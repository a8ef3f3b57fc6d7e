"""One run of one cell: set-up, the measured window (or the traced one),
the check against the plain reference, and the result line."""

from __future__ import annotations

import gc
import json
import sys
import time
from types import SimpleNamespace

import torch

from . import checks, guard, peaks, trace


class GuardError(RuntimeError):
    """JAX or the JAX package is loaded in the measuring process."""


def _guard(when):
    found = guard.forbidden_modules()
    if found:
        raise GuardError(f"loaded {when}: {', '.join(found)}")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _jobs(mod, state, device, seconds=None, count=None, after=True):
    """Jobs back to back until ``count`` have run, or until one ends after
    ``seconds`` at a point where the job module's ``closes(state,
    records)`` allows the window to close (any job's end, if it has none);
    each timed by the host clock from its start to the fence after it, its
    off-clock work (``after_job``) outside that time, or left to the caller
    with ``after=False``."""
    records, spent = [], 0.0
    after = getattr(mod, "after_job", None) if after else None
    closes = getattr(mod, "closes", lambda state, records: True)
    while True:
        t0 = time.perf_counter()
        rec = mod.job(state, len(records))
        _sync(device)
        rec["wall_s"] = time.perf_counter() - t0
        spent += rec["wall_s"]
        if after is not None:
            after(state, rec)
        rec.setdefault("failed", False)
        records.append(rec)
        if count is not None and len(records) >= count:
            return records
        if seconds is not None and spent >= seconds \
                and closes(state, records):
            return records


def run_cell(cell, seed, seconds, traced, device, t_start):
    """Run ``cell`` once on ``device``; returns ``(result dict, check
    lines)``.  ``t_start``: the process's start on the host clock."""
    mod = cell.job_module()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ctx = SimpleNamespace(device=device, seed=int(seed), config=cell.config,
                          traffic=cell.traffic)
    state = mod.setup(ctx)
    _sync(device)
    _guard("after set-up")
    setup_s = time.perf_counter() - t_start
    tr = None
    if traced:
        # the jobs' off-clock work (a NUTS job's ESS) runs after the trace
        records, tr = trace.record(torch, lambda: _jobs(
            mod, state, device, count=int(cell.traffic["trace_jobs"]),
            after=False), cuda=device.type == "cuda")
        for rec in records:
            if hasattr(mod, "after_job"):
                mod.after_job(state, rec)
    else:
        records = _jobs(mod, state, device, seconds=float(seconds))
    _guard("after the window")
    run = SimpleNamespace(
        cell=cell.name, config=cell.config, traffic=cell.traffic,
        records=records, setup_s=setup_s,
        window_s=sum(r["wall_s"] for r in records), trace=tr,
        facts=mod.facts(state),
        peaks=peaks.card_peaks(torch) if device.type == "cuda" else {})
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = cell.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else 0)}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
    mod.release(state)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    found = mod.check(state, records, seed)
    result = {"correct": checks.all_within(found),
              "attempted": len(records),
              "failed": sum(bool(r["failed"]) for r in records),
              "metrics": metrics, "device": dev}
    walls = [r["wall_s"] for r in records]
    result["jobs"] = {"wall_s_min": min(walls), "wall_s_max": max(walls)}
    if tr is not None:
        result["breakdown"] = tr.breakdown()
    if run.peaks.get("power_limit_w") is not None:
        result["power_limit_w"] = run.peaks["power_limit_w"]
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in found}
    return result, found


def emit(result, found, out=sys.stdout, err=sys.stderr):
    """The check lines last on standard error, the result line last on
    standard output."""
    for c in found:
        print(f"check {c['name']} = {c['value']!r} (limit {c['limit']!r})",
              file=err, flush=True)
    print(json.dumps(result), file=out, flush=True)
