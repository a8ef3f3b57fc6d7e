"""The fused trainer's own host time a call, in ms: the mean over calls of
the program's span ``bayesic.ops.fused_vae.fused_train`` less its child
``bayesic.ops.fused_vae.launch`` (the C call that enqueues the kernels):
checks, packs, allocations and unpacking."""

from portbench.harness import spans


def read(run):
    calls = spans.named(run.trace, "bayesic.ops.fused_vae.fused_train")
    if not calls:
        return None
    launches = spans.named(run.trace, "bayesic.ops.fused_vae.launch")
    return 1e3 * sum(spans.self_s(c, launches) for c in calls) / len(calls)
