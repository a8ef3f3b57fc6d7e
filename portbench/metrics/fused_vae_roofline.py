"""The SVI steps' least time (``counts/fused_vae``: operations at the TF32
peak or bytes at the HBM peak, whichever is larger) over the device time
of the fused trainer's kernels, in %."""

from portbench.counts import fused_vae
from portbench.harness import readers


def read(run):
    f = run.facts
    dims = (f["data_dim"], f["hidden"], f["latent"], f["batch"])
    steps = readers.total(run, "steps")
    bound = readers.bound_seconds(run, steps * fused_vae.step_flops(*dims),
                                  steps * fused_vae.step_bytes(*dims))
    return readers.kernel_share(run, bound, fused_vae.KERNELS)
