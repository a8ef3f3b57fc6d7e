"""bayesic_tpu_torch — the PyTorch/CUDA port of bayesic_tpu.

Mirrors the JAX package's module tree; ``bayesic_tpu`` stays the reference
each module is tested against.  Ported so far: the DLGM's SVI and
local-posterior NUTS paths, the hierarchical logistic regression's SVI
and full-batch NUTS paths, the Gaussian mixture's tempered SMC, the linear
regression's SVI and the matrix factorization's mini-batch and dense SVI.

Layering:
  dist/      distributions + transforms
  core/      model DSL + joint log-prob compiler
  infer/svi  STL ELBO, amortized, mean-field and full-rank guides, Adam
  infer/mcmc NUTS/HMC, adaptation, the MCMC driver
  infer/smc  adaptive tempered SMC with HMC mutation
  parallel/  systematic resampling (one device)
  ops/       hand-written Hopper kernels (csrc/) + plain PyTorch versions
  models/    the DLGM, the hierarchical logistic regression, the GMM,
             the linear regression, the matrix factorization
  interop    JAX parameters (as numpy) <-> the port's parameters
"""

__version__ = "0.1.0"

from . import dist  # noqa: F401
from .core import param, plate, sample  # noqa: F401
