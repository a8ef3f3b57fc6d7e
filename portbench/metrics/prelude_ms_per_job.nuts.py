"""The host time of a NUTS job before its first transition, in ms: the
mean over jobs of the program's span
``bayesic.models.dlgm.local_posterior_mcmc_fused`` (the transition's
set-up and the ``MCMC`` build, the model's discovery trace) and its
``bayesic.mcmc.init`` span (the initial points and the chains' first
potential), the union of the two."""

from portbench.harness import spans


def read(run):
    jobs = spans.named(run.trace,
                       "bayesic.models.dlgm.local_posterior_mcmc_fused")
    if not jobs:
        return None
    inits = spans.named(run.trace, "bayesic.mcmc.init")
    return 1e3 * spans.covered_s(jobs + inits) / len(jobs)
