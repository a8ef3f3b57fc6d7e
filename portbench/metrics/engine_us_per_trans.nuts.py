"""The ``MCMC`` engine's own host time a transition, in us: the program's
spans ``bayesic.mcmc.warmup`` and ``bayesic.mcmc.sample`` less what their
``bayesic.mcmc.transition`` children and the CUDA runtime calls outside
those children cover (a launch that blocks on a full queue waits for the
card), over the number of transition spans within them."""

from portbench.harness import spans


def read(run):
    loops = spans.named(run.trace, "bayesic.mcmc.warmup") \
        + spans.named(run.trace, "bayesic.mcmc.sample")
    if not loops:
        return None
    trans = spans.named(run.trace, "bayesic.mcmc.transition")
    runtime = spans.runtime_calls(run.trace)
    own, count = 0.0, 0
    for loop in loops:
        kids = spans.inside(loop, trans)
        count += len(kids)
        own += spans.self_s(loop, kids + runtime)
    return 1e6 * own / count if count else None
