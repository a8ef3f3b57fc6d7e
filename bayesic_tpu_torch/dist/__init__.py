"""Distributions library: the subset of ``bayesic_tpu.dist`` that the
ported paths need (Normal, HalfNormal, Bernoulli, expand/to_event/
Independent, real, positive and boolean constraints, Identity/Exp
bijectors)."""

from . import constraints
from .continuous import HalfNormal, Normal
from .discrete import Bernoulli
from .distribution import Distribution, Independent
from .transforms import Exp, Identity, Transform, biject_to

__all__ = [
    "constraints",
    "Distribution",
    "Independent",
    "Normal",
    "HalfNormal",
    "Bernoulli",
    "Transform",
    "Identity",
    "Exp",
    "biject_to",
]
