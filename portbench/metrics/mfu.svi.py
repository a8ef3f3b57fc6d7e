"""The SVI steps' operations (``counts/fused_vae``) over the traced
window's seconds times the TF32 peak, in %."""

from portbench.counts import fused_vae
from portbench.harness import readers


def read(run):
    if run.trace is None or not run.peaks:
        return None
    f = run.facts
    flops = readers.total(run, "steps") * fused_vae.step_flops(
        f["data_dim"], f["hidden"], f["latent"], f["batch"])
    return 100.0 * flops / (run.trace.window_s * run.peaks["tf32_flops"])
