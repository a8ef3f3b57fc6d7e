"""The device's idle time inside the fused trainer's calls, over the
traced window, in %: for each call's C call (the program's span
``bayesic.ops.fused_vae.launch``), from the first device op that starts
after the span's start to the end of the last one that starts before the
next call (the span ``bayesic.ops.fused_vae.fused_train``) or the trace's
end.  The rest of ``idle.svi`` lies between calls."""

from portbench.harness import spans


def read(run):
    launches = spans.named(run.trace, "bayesic.ops.fused_vae.launch")
    if not launches or run.trace.window_s <= 0:
        return None
    calls = [c[0] for c in
             spans.named(run.trace, "bayesic.ops.fused_vae.fused_train")]
    ends = [next((c for c in calls if c > s[0]), None) for s in launches]
    idle = spans.device_idle_after(run.trace, [s[0] for s in launches],
                                   ends)
    return 100.0 * sum(idle) / run.trace.window_s
