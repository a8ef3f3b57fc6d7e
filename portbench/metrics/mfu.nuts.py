"""Every leapfrog of the traced jobs, warm-up and sampling (the run's
``num_steps`` summed over chains and transitions), at its operations
(``counts/fused_nuts``) over the traced window's seconds times the TF32
peak, in %: the whole job's share of the peak, idle time included."""

from portbench.counts import fused_nuts
from portbench.harness import readers


def read(run):
    if run.trace is None or not run.peaks:
        return None
    f = run.facts
    flops = readers.total(run, "leapfrogs") * fused_nuts.leapfrog_flops(
        f["rows"], f["latent"], f["hidden"], f["data_dim"])
    return 100.0 * flops / (run.trace.window_s * run.peaks["tf32_flops"])
