"""Distributions library: the subset of ``bayesic_tpu.dist`` that the DLGM
SVI path needs (Normal, expand/to_event/Independent, real and positive
constraints, Identity/Exp bijectors)."""

from . import constraints
from .continuous import Normal
from .distribution import Distribution, Independent
from .transforms import Exp, Identity, Transform, biject_to

__all__ = [
    "constraints",
    "Distribution",
    "Independent",
    "Normal",
    "Transform",
    "Identity",
    "Exp",
    "biject_to",
]
