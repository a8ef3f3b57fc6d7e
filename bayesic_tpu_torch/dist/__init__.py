"""Distributions library and transforms: the port of ``bayesic_tpu.dist``
(every family of the JAX package's ``__all__``)."""

from . import constraints
from .compound import (BetaBinomial, Censored, DirichletMultinomial,
                       GaussianRandomWalk, Truncated, VonMises,
                       ZeroInflatedDistribution,
                       ZeroInflatedNegativeBinomial, ZeroInflatedPoisson)
from .continuous import (Beta, Cauchy, Chi2, Exponential, Gamma, Gumbel,
                         HalfCauchy, HalfNormal, InverseGamma, Laplace,
                         LogNormal, Normal, Pareto, StudentT,
                         TruncatedNormal, Uniform, Weibull)
from .discrete import (Bernoulli, Binomial, Categorical, Geometric,
                       Multinomial, NegativeBinomial, OrderedLogistic,
                       Poisson)
from .distribution import (Delta, Distribution, Independent,
                           TransformedDistribution)
from .hmm import HiddenMarkovModel
from .lgss import LinearGaussianStateSpace
from .mixture import MixtureSameFamily
from .multivariate import (Dirichlet, InverseWishart, LKJCholesky,
                           MatrixNormal, MultivariateNormal,
                           MultivariateStudentT, Wishart)
from .transforms import (Exp, Identity, LowerCholeskyTransform,
                         StickBreaking, Transform, biject_to)

__all__ = [
    "constraints",
    "biject_to",
    "Distribution",
    "Independent",
    "Delta",
    "TransformedDistribution",
    "Normal",
    "LogNormal",
    "HalfNormal",
    "Cauchy",
    "HalfCauchy",
    "StudentT",
    "Laplace",
    "Exponential",
    "Gamma",
    "InverseGamma",
    "Beta",
    "Uniform",
    "TruncatedNormal",
    "Bernoulli",
    "Binomial",
    "Categorical",
    "Poisson",
    "Geometric",
    "NegativeBinomial",
    "Multinomial",
    "OrderedLogistic",
    "Weibull",
    "Gumbel",
    "Pareto",
    "Chi2",
    "MultivariateNormal",
    "Dirichlet",
    "LKJCholesky",
    "MultivariateStudentT",
    "MatrixNormal",
    "Wishart",
    "InverseWishart",
    "BetaBinomial",
    "Censored",
    "Truncated",
    "DirichletMultinomial",
    "GaussianRandomWalk",
    "VonMises",
    "ZeroInflatedDistribution",
    "ZeroInflatedPoisson",
    "ZeroInflatedNegativeBinomial",
    "HiddenMarkovModel",
    "LinearGaussianStateSpace",
    "MixtureSameFamily",
    # transforms the earlier slices exported at the package level
    "Transform",
    "Identity",
    "Exp",
    "StickBreaking",
    "LowerCholeskyTransform",
]
