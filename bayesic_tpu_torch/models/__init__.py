"""The example models: the five reference configurations (the DLGM, the
hierarchical logistic regression, the GMM, the linear regression, the
matrix factorization) and the GP regression, the structural time series
and the sparse variational GP, as in the JAX package."""

from . import (dlgm, gmm, gp, hier_logistic, linreg, matrix_fact,  # noqa: F401
               sts, svgp)
