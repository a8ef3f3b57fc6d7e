"""Distributions library: the subset of ``bayesic_tpu.dist`` that the
ported paths need (Normal, HalfNormal, Bernoulli, Categorical, Dirichlet,
MixtureSameFamily, expand/to_event/Independent, real, positive, simplex,
lower-Cholesky and discrete constraints, Identity/Exp/StickBreaking/
LowerCholesky bijectors)."""

from . import constraints
from .continuous import HalfNormal, Normal
from .discrete import Bernoulli, Categorical
from .distribution import Distribution, Independent
from .mixture import MixtureSameFamily
from .multivariate import Dirichlet
from .transforms import (Exp, Identity, LowerCholeskyTransform,
                         StickBreaking, Transform, biject_to)

__all__ = [
    "constraints",
    "Distribution",
    "Independent",
    "Normal",
    "HalfNormal",
    "Bernoulli",
    "Categorical",
    "Dirichlet",
    "MixtureSameFamily",
    "Transform",
    "Identity",
    "Exp",
    "StickBreaking",
    "LowerCholeskyTransform",
    "biject_to",
]
