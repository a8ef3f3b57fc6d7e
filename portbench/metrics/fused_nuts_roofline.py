"""Every leapfrog of the traced jobs, warm-up and sampling (the run's
``num_steps`` summed over chains and transitions), at its least time
(``counts/fused_nuts``: operations at the TF32 peak, or bytes at the HBM
peak) over the device time of the NUTS kernel's launches, in %."""

from portbench.counts import fused_nuts
from portbench.harness import readers


def read(run):
    f = run.facts
    dims = (f["rows"], f["latent"], f["hidden"], f["data_dim"])
    n = readers.total(run, "leapfrogs")
    bound = readers.bound_seconds(run, n * fused_nuts.leapfrog_flops(*dims),
                                  n * fused_nuts.leapfrog_bytes(*dims))
    return readers.kernel_share(run, bound, fused_nuts.KERNELS)
