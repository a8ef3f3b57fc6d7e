"""The device trace of a traced run, read from ``torch.profiler``.

The device's busy time is the union of its kernel, copy and set intervals
(the method of the port's ``chip_smoke._trace``, copied here so that the
yardstick does not move with the program); the idle share is one minus
busy over the traced window.  Host operations (PyTorch ops, CUDA runtime
calls and the benchmark's own ``record_function`` spans) label the idle
gaps by what the host was doing."""

from __future__ import annotations

import time

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def short_name(name):
    """A kernel's name without namespace, template arguments or
    parameters: ``void ns::row_kernel<4>(Args)`` -> ``row_kernel``."""
    name = name.replace("(anonymous namespace)::", "")
    base = name.split("(")[0].split("<")[0].split()
    return base[-1].split("::")[-1] if base else name


def union_seconds(intervals):
    """Length of the union of ``(start, end)`` intervals in seconds (the
    intervals in ns)."""
    busy, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy * 1e-9


def _kind(ev):
    """The event's activity kind: ``activity_type()`` where the profiler
    gives it, else from its device and its annotation flag (the benchmark's
    own spans, named ``portbench.*``, are annotations on either side)."""
    f = getattr(ev, "activity_type", None)
    if f is not None:
        return str(f()).lower()
    ann = getattr(ev, "is_user_annotation", lambda: False)() \
        or ev.name().startswith("portbench.")
    if "cuda" in str(ev.device_type()).lower():
        return "gpu_user_annotation" if ann else "kernel"
    return "user_annotation" if ann else "cpu_op"


def _ns(ev, which):
    f = getattr(ev, f"{which}_ns", None)
    if f is not None:
        return int(f())
    if which == "end":
        d = getattr(ev, "duration_ns", None)
        span = int(d()) if d is not None else int(ev.duration_us() * 1000)
        return _ns(ev, "start") + span
    return int(getattr(ev, f"{which}_us")() * 1000)


class Trace:
    """Device ops and host ops, each ``(start_ns, end_ns, name)``, and the
    traced window's length in seconds (host clock, fenced)."""

    def __init__(self, device_ops, host_ops, window_s):
        self.device_ops = sorted(device_ops)
        self.host_ops = sorted(host_ops)
        self.window_s = float(window_s)

    @property
    def busy_s(self):
        return union_seconds((s, e) for s, e, _ in self.device_ops)

    def named(self, names):
        """The device ops whose short name is one of ``names``, in order."""
        names = set(names)
        return [op for op in self.device_ops if short_name(op[2]) in names]

    def seconds(self, names):
        return sum(e - s for s, e, _ in self.named(names)) * 1e-9

    def gaps(self):
        """Idle gaps between the union's busy intervals: ``(start, end)``
        in ns."""
        out, cur_e = [], None
        for s, e, _ in self.device_ops:
            if cur_e is not None and s > cur_e:
                out.append((cur_e, s))
            cur_e = e if cur_e is None else max(cur_e, e)
        return out

    def breakdown(self, top=10, labelled=200):
        """The device ops that took most time, by name, and the
        ``labelled`` longest idle gaps summed by the innermost host op
        that spans each gap's middle."""
        import numpy as np

        by_name = {}
        for s, e, name in self.device_ops:
            k = short_name(name)
            by_name[k] = by_name.get(k, 0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        longest = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:labelled]
        starts = np.array([h[0] for h in self.host_ops], dtype=np.int64)
        ends = np.array([h[1] for h in self.host_ops], dtype=np.int64)
        by_host = {}
        for gs, ge in longest:
            mid = (gs + ge) // 2
            inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
            label = "no host op"
            if inside.size:
                j = inside[np.argmin(ends[inside] - starts[inside])]
                label = self.host_ops[j][2]
            by_host[label] = by_host.get(label, 0) + (ge - gs)
        gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v * 1e-9] for k, v in ops],
                "idle_gaps": [[k, v * 1e-9] for k, v in gaps]}


def record(torch, fn, cuda=True):
    """Run ``fn`` under the profiler, fenced; returns ``(fn's result,
    Trace)``.  ``cuda=False`` records the host alone (the CPU tests)."""
    from torch.profiler import ProfilerActivity, profile

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CPU]
                 + [ProfilerActivity.CUDA] * cuda) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        window = time.perf_counter() - t0
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        kind = _kind(ev)
        item = (_ns(ev, "start"), _ns(ev, "end"), ev.name())
        if kind in DEVICE_KINDS:
            dev.append(item)
        elif kind in ("cpu_op", "cuda_runtime", "user_annotation"):
            host.append(item)
    return out, Trace(dev, host, window)
