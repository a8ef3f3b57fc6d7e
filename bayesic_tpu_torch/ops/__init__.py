"""Hand-written Hopper kernels (``csrc/``) with their plain PyTorch
versions.  A wrapper runs the plain version only for tensors on the CPU; on
a CUDA tensor it launches the kernel or raises.  ``fused_nuts`` and
``fused_nuts_hier`` build on ``infer.mcmc`` (as ``gmm_logprob`` and
``fused_smc_gmm`` do through ``fused_nuts``'s launch helpers), and the
entry points of ``fused_hier``, ``fused_linreg`` and ``mf_dense`` share
``fused_vae``'s names, so those seven are imported as modules."""

from .fused_vae import fused_train, fused_train_injected, reference_train

__all__ = ["fused_train", "fused_train_injected", "reference_train"]
