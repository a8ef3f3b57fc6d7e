"""bayesic_tpu_torch — the PyTorch/CUDA port of bayesic_tpu.

Mirrors the JAX package's module tree; ``bayesic_tpu`` stays the reference
each module is tested against.  Every module of it is ported: the model DSL with every
distribution family (the hidden-Markov and linear-Gaussian state-space
models among them); SVI with the STL, IWAE and DReG bounds and mean-field,
full-rank, low-rank, flow, amortized and DSL-authored guides; NUTS/HMC;
tempered SMC; posterior predictives, pointwise log-likelihoods,
WAIC/PSIS-LOO and SBC; discrete enumeration and ``infer_discrete``;
elliptical slice, parallel tempering, NUTS within Gibbs, SG-MCMC,
MAP/Laplace, SVGD and Pathfinder; the sharded paths over the
``"data"``, ``"chain"``, ``"particle"`` and ``"model"`` mesh axes (the
last splits parameters and observations: ``parallel.tp``); and the eight
models (the DLGM's SVI, with its bf16 compute mode, and local-posterior
NUTS, the hierarchical logistic regression's SVI and full-batch NUTS,
the Gaussian mixture's tempered SMC, the linear regression's SVI, the
matrix factorization's mini-batch and dense SVI, the GP regression, the
structural time series and the sparse variational GP).

Layering:
  dist/      distributions + transforms
  core/      model DSL + joint log-prob compiler
  infer/svi  ELBOs (STL, IWAE, DReG), guides, Adam, the SVI loop
  infer/mcmc NUTS/HMC, adaptation, the MCMC driver, elliptical slice,
             parallel tempering, NUTS within Gibbs
  infer/smc  adaptive tempered SMC with HMC mutation
  infer/     Predictive, log_likelihood, infer_discrete, SG-MCMC,
             MAP/Laplace, SVGD, Pathfinder (L-BFGS with a zoom line search)
  parallel/  torch.distributed: data-parallel SVI, sharded chains and
             particles, the ring resampler, the launcher, the "model"
             axis (split parameters and observations, differentiable
             collectives)
  ops/       hand-written Hopper kernels (csrc/) + plain PyTorch versions
  models/    the DLGM, the hierarchical logistic regression, the GMM,
             the linear regression, the matrix factorization, the GP,
             the structural time series, the sparse variational GP
  utils/     diagnostics, checkpoints, config, metrics, WAIC/LOO, SBC
  io/        the native ratings loader
  interop    JAX parameters (as numpy) <-> the port's parameters
"""

__version__ = "0.1.0"

from . import dist  # noqa: F401
from .core import (  # noqa: F401
    deterministic,
    factor,
    param,
    plate,
    sample,
)


def __getattr__(name):
    # lazy imports so `import bayesic_tpu_torch` stays cheap
    if name == "SVI":
        from .infer.svi import SVI
        return SVI
    if name == "MCMC":
        from .infer.mcmc import MCMC
        return MCMC
    if name == "SMC":
        from .infer.smc import SMC
        return SMC
    if name == "Predictive":
        from .infer.predictive import Predictive
        return Predictive
    if name == "log_likelihood":
        from .infer.loglik import log_likelihood
        return log_likelihood
    if name == "Laplace":
        from .infer.laplace import Laplace
        return Laplace
    if name == "map_estimate":
        from .infer.laplace import map_estimate
        return map_estimate
    if name == "ParallelTempering":
        from .infer.mcmc import ParallelTempering
        return ParallelTempering
    if name == "SGMCMC":
        from .infer.sgmcmc import SGMCMC
        return SGMCMC
    if name == "SVGD":
        from .infer.svgd import SVGD
        return SVGD
    raise AttributeError(name)
